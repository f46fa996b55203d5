"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``, on the CPU.

- ``obs.trace``: spans nest, inherit ambient ids, export as valid Chrome
  trace-event JSON, and every opened span CLOSES even when the traced code
  dies mid-stage (a chaos-killed lane), so ``open_spans == 0`` after a
  crashy run and the export still parses. The export's shape and the text
  summary's layout are the reference's.
- ``obs.energy``: the modeled meter fills the ``StageStats`` energy fields
  with the reference's watts (host profile != device profile), measured
  meters (RAPL on a fake powercap tree) unwrap counter wraparound and
  degrade to unavailable instead of raising, NVML is unavailable where its
  library is absent, and ``merge_from`` accumulates joules like any other
  per-stage cost.
- ``obs.metrics``: counters / gauges / histograms aggregate and export as
  the reference's do.

Races are ordered by events, not by wall-clock margins.
"""
import json
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.obs as JO  # noqa: E402
from repro.mapreduce.instrumentation import StageStats as JStageStats  # noqa: E402
import repro_torch.mapreduce as T  # noqa: E402
from repro_torch.data import sky  # noqa: E402
from repro_torch.data.pipeline import ArraySplits  # noqa: E402
from repro_torch.ft import LaneChaos  # noqa: E402
from repro_torch.mapreduce.instrumentation import StageStats  # noqa: E402
from repro_torch.obs import (ATOM_HOST, BLADE_DEVICE,  # noqa: E402
                             MetricsRegistry, ModeledMeter, NullTracer,
                             NvmlMeter, RaplMeter, Tracer, get_meter,
                             get_tracer, pick_meter, use_meter, use_tracer)
from repro_torch.obs.metrics import Histogram  # noqa: E402
from test_torch_chaos import _Gated  # noqa: E402

RADIUS = 0.02
STALL_S = 60.0

ENERGY_FIELDS = ("energy_j", "map_energy_j", "shuffle_energy_j",
                 "reduce_energy_j", "fetch_energy_j", "combine_energy_j",
                 "spill_energy_j")


def _catalog(n=3000, seed=0):
    return sky.make_catalog(n, seed)


def _job():
    return T.neighbor_search_job(RADIUS, tile=128)


def _mono(job, xyz, **kw):
    return T.run_job(job, xyz, device="cpu", **kw)


# ---------------------------------------------------------------------------
# StageStats energy accumulation
# ---------------------------------------------------------------------------

def test_merge_from_sums_energy_fields():
    kw_a = dict(job="x", engine="host", energy_source="modeled:atom-host",
                energy_j=3.0, map_energy_j=1.0, shuffle_energy_j=0.5,
                reduce_energy_j=1.5, n_items=100)
    kw_b = dict(job="x", engine="host", energy_source="modeled:atom-host",
                energy_j=2.0, map_energy_j=0.5, shuffle_energy_j=0.5,
                reduce_energy_j=0.25, fetch_energy_j=0.25,
                combine_energy_j=0.25, spill_energy_j=0.25, n_items=100)
    a = StageStats(**kw_a).merge_from(StageStats(**kw_b))
    ja = JStageStats(**kw_a).merge_from(JStageStats(**kw_b))
    for f in ENERGY_FIELDS + ("energy_source", "n_items"):
        assert getattr(a, f) == getattr(ja, f), f
    assert a.energy_j == pytest.approx(5.0)
    assert a.spill_energy_j == pytest.approx(0.25)
    assert a.rows_per_joule == pytest.approx(200 / 5.0) == ja.rows_per_joule
    empty = StageStats().merge_from(StageStats(energy_source="nvml"))
    assert empty.energy_source == "nvml"


def test_rows_per_joule_zero_when_unmetered():
    assert StageStats(n_items=100).rows_per_joule == 0.0
    assert StageStats(n_items=100).to_dict()["rows_per_joule"] == 0.0


def test_spill_wall_counts_in_wall_and_dominant_stage():
    st = StageStats(map_wall_s=0.5, spill_wall_s=2.0)
    jst = JStageStats(map_wall_s=0.5, spill_wall_s=2.0)
    assert st.wall_s == jst.wall_s == 2.5
    assert st.dominant_stage == jst.dominant_stage == "spill"


# ---------------------------------------------------------------------------
# Tracer unit behaviour
# ---------------------------------------------------------------------------

def _shape(doc):
    """An export with its clock and process values taken out."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid",
                                                      "tid")}
            for e in doc["traceEvents"]]


def _nested(tr):
    with tr.ids(lane=2, split=7):
        with tr.span("outer", cat="stage"):
            with tr.span("inner", cat="io", attempt=1):
                pass
    tr.instant("mark", split=7)


def test_tracer_nesting_ids_and_export_shape():
    tr, jtr = Tracer(), JO.Tracer()
    _nested(tr)
    _nested(jtr)
    assert tr.open_spans == 0
    doc = json.loads(tr.export_json())
    assert doc["displayTimeUnit"] == "ms"
    assert _shape(doc) == _shape(json.loads(jtr.export_json()))
    evs = {e["name"]: e for e in doc["traceEvents"]}
    inner = evs["inner"]
    assert inner["ph"] == "X" and inner["dur"] >= 0.0
    assert {"ts", "pid", "tid", "args"} <= set(inner)
    assert inner["args"] == {"lane": 2, "split": 7, "attempt": 1}
    assert evs["mark"]["ph"] == "i" and evs["mark"]["s"] == "t"
    # inner closed first: events append at close time
    assert doc["traceEvents"].index(inner) < \
        doc["traceEvents"].index(evs["outer"])


def test_tracer_span_closes_on_exception():
    tr = Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("doomed"):
            raise RuntimeError("mid-stage death")
    assert tr.open_spans == 0
    assert tr.events[0]["name"] == "doomed"


def test_tracer_record_retroactive_and_summary():
    clock = iter(np.arange(0.0, 100.0, 0.25)).__next__
    tr, jtr = Tracer(clock=clock), JO.Tracer(clock=clock)
    for t in (tr, jtr):
        t0 = t.now()
        t.record("fetch-wait", t0, t0 + 0.001, cat="io", split=3)
        t.record("clock-skew", t0 + 1.0, t0)     # clamps to zero
        t.instant("clone-win", split=3)
    assert tr.events[0]["dur"] == pytest.approx(1000.0)
    assert tr.events[1]["dur"] == 0.0
    text = tr.summary()
    assert "fetch-wait" in text and "count" in text and "(instant)" in text
    assert text == jtr.summary()


def test_tracer_threads_keep_separate_ambient_ids():
    tr = Tracer()
    errs = []
    go = threading.Event()

    def worker(lane):
        try:
            go.wait(STALL_S)
            with tr.ids(lane=lane):
                for _ in range(50):
                    with tr.span("w"):
                        pass
        except Exception as e:          # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    go.set()
    for t in ts:
        t.join(timeout=STALL_S)
    assert not any(t.is_alive() for t in ts)
    assert not errs and tr.open_spans == 0
    assert len(tr.events) == 200
    by_tid = {}
    for ev in tr.events:
        by_tid.setdefault(ev["tid"], set()).add(ev["args"]["lane"])
    # each thread's spans carry its own lane id, never another thread's
    assert sorted(len(v) for v in by_tid.values()) == [1, 1, 1, 1]


def test_null_tracer_is_reentrant_noop():
    tr = NullTracer()
    with tr.span("a"), tr.ids(x=1), tr.span("b"):
        tr.instant("c")
        tr.record("d", 0.0, 1.0)
    assert tr.events == () and tr.open_spans == 0 and not tr.enabled
    assert isinstance(get_tracer(), NullTracer)  # module default stays null


# ---------------------------------------------------------------------------
# Tracing threaded through the runtime, and under chaos
# ---------------------------------------------------------------------------

@pytest.mark.timeout_s(300)
def test_streaming_run_traces_stages_and_exports_valid_json(tmp_path):
    """Sequential (prefetched) spilled run, then lanes: every stage span
    is recorded, spill-write and spill-read included, and the export
    parses; tracing changes no output."""
    xyz = _catalog()
    job = _job()
    want = _mono(job, xyz).output
    with use_tracer(Tracer()) as tr:
        res = T.run_job_streaming(job, ArraySplits(xyz, n_splits=6),
                                  prefetch=2, spill=0, device="cpu")
        lanes = T.run_job_streaming(job, ArraySplits(xyz, n_splits=6),
                                    n_lanes=3, device="cpu")
    assert res.output == lanes.output == want
    assert res.stats.spilled_splits == 6
    assert tr.open_spans == 0
    doc = json.loads(tr.export_json())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"job", "fetch", "fetch-wait", "map", "shuffle", "reduce",
            "spill-write", "spill-read", "lane-exec"} <= names
    reads = [e for e in doc["traceEvents"] if e["name"] == "spill-read"]
    assert sorted(e["args"]["range"] for e in reads) == \
        list(range(res.stats.spill_ranges))
    lane_ev = next(e for e in doc["traceEvents"] if e["name"] == "lane-exec")
    assert "lane" in lane_ev["args"] and "split" in lane_ev["args"]
    jobs = [e for e in doc["traceEvents"] if e["name"] == "job"]
    assert sorted(e["args"]["mode"] for e in jobs) == ["lanes", "stream"]


@pytest.mark.timeout_s(300)
def test_host_engine_and_combine_spans():
    toks = (np.arange(3000) % 89).astype(np.float32).reshape(-1, 1)
    with use_tracer(Tracer()) as tr:
        T.run_job(_job(), _catalog(800), engine="host", device="cpu")
        T.run_job_streaming(T.token_histogram_job(89),
                            ArraySplits(toks, n_splits=3), device="cpu")
    engines = {(e["name"], e["args"].get("engine")) for e in tr.events}
    assert {("map", "host"), ("shuffle", "host"),
            ("reduce", "host")} <= engines
    combines = [e for e in tr.events if e["name"] == "combine"]
    assert sorted(e["args"]["split"] for e in combines) == [0, 1, 2]
    assert tr.open_spans == 0


@pytest.mark.timeout_s(300)
def test_chaos_killed_lane_leaves_no_open_spans():
    """Lane 0 dies on its first task, and no fetch proceeds before that
    death (so lane 0 is sure to take a task): its span closes in
    ``finally``, the split requeues, and the export stays valid Chrome
    trace JSON."""
    xyz = _catalog()
    job = _job()
    want = _mono(job, xyz).output
    chaos = LaneChaos(kills=[(0, 0)])
    src = _Gated(ArraySplits(xyz, n_splits=6), lambda: chaos.deaths)
    with use_tracer(Tracer()) as tr:
        res = T.run_job_streaming(job, src, n_lanes=3, chaos=chaos,
                                  device="cpu")
    assert res.output == want and len(chaos.deaths) == 1
    assert tr.open_spans == 0
    doc = json.loads(tr.export_json())
    for ev in doc["traceEvents"]:
        assert ev["ph"] in ("X", "i")
        if ev["ph"] == "X":
            assert ev["dur"] >= 0.0
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"map", "shuffle", "reduce", "lane-exec"} <= names
    killed = [e for e in doc["traceEvents"] if e["name"] == "lane-exec"
              and e["args"]["lane"] == 0]
    assert len(killed) == 1                     # the span of the dying task


# ---------------------------------------------------------------------------
# Energy meters
# ---------------------------------------------------------------------------

@pytest.mark.timeout_s(300)
def test_modeled_meter_fills_energy_fields_by_engine():
    xyz = _catalog()
    job = _job()
    outs = {}
    with use_meter(ModeledMeter()):
        for engine in ("host", "device"):
            r = _mono(job, xyz, engine=engine)
            outs[engine] = r
            st = r.stats
            assert st.energy_j > 0.0
            assert st.map_energy_j > 0.0 and st.reduce_energy_j > 0.0
            assert st.rows_per_joule > 0.0
            parts = sum(getattr(st, f) for f in ENERGY_FIELDS[1:])
            assert st.energy_j == pytest.approx(parts)
            # modeled joules are the profile's watts x the stage walls
            prof = ATOM_HOST if engine == "host" else BLADE_DEVICE
            assert st.map_energy_j == pytest.approx(
                st.map_wall_s * prof.compute_w)
    assert outs["host"].stats.energy_source == "modeled:atom-host"
    assert outs["device"].stats.energy_source == "modeled:amdahl-blade"
    assert outs["host"].output == outs["device"].output  # metering is free
    assert get_meter().name == "null"


def test_modeled_meter_charges_class_watts():
    assert (ATOM_HOST, BLADE_DEVICE) == (
        type(ATOM_HOST)(**vars(JO.ATOM_HOST)),
        type(BLADE_DEVICE)(**vars(JO.BLADE_DEVICE)))
    walls = dict(map_wall_s=1.0, shuffle_wall_s=2.0, fetch_wall_s=0.5,
                 spill_wall_s=0.25, reduce_wall_s=0.125)
    for engine in ("device", "host"):
        st = StageStats(engine=engine, **walls)
        jst = JStageStats(engine=engine, **walls)
        ModeledMeter().attribute(None, st)
        JO.ModeledMeter().attribute(None, jst)
        for f in ENERGY_FIELDS + ("energy_source",):
            assert getattr(st, f) == getattr(jst, f), (engine, f)
    st = StageStats(engine="device", map_wall_s=1.0, shuffle_wall_s=2.0)
    ModeledMeter().attribute(None, st)
    assert st.map_energy_j == pytest.approx(1.0 * BLADE_DEVICE.compute_w)
    assert st.shuffle_energy_j == pytest.approx(2.0 * BLADE_DEVICE.io_w)
    assert ATOM_HOST.io_w > ATOM_HOST.compute_w      # CPU pays for I/O
    assert BLADE_DEVICE.io_w < BLADE_DEVICE.compute_w


def _fake_rapl(root, uj, max_uj=1000_000.0):
    d = root / "intel-rapl:0"
    d.mkdir(parents=True, exist_ok=True)
    (d / "energy_uj").write_text(f"{uj:.0f}\n")
    (d / "max_energy_range_uj").write_text(f"{max_uj:.0f}\n")
    return d


def test_rapl_meter_reads_delta_and_unwraps(tmp_path):
    d = _fake_rapl(tmp_path, 500_000.0)
    sub = tmp_path / "intel-rapl:0:0"        # a subdomain must NOT be summed
    sub.mkdir()
    (sub / "energy_uj").write_text("999\n")
    (sub / "max_energy_range_uj").write_text("1000000\n")
    m = RaplMeter(root=str(tmp_path))
    assert m.available and len(m._domains) == 1
    tok = m.begin()
    (d / "energy_uj").write_text("800000\n")
    assert m.read_joules(tok) == pytest.approx(0.3)      # 300k uJ
    tok = m.begin()
    (d / "energy_uj").write_text("100000\n")             # wrapped past 1e6
    assert m.read_joules(tok) == pytest.approx(0.3)      # (1e6-8e5)+1e5
    st = StageStats(engine="host", map_wall_s=0.75, shuffle_wall_s=0.25)
    tok = m.begin()
    (d / "energy_uj").write_text("200000\n")
    m.attribute(tok, st)
    assert st.energy_j == pytest.approx(0.1)
    assert st.map_energy_j == pytest.approx(0.075)       # wall-share split
    assert st.energy_source == "rapl"


def test_rapl_meter_unavailable_degrades(tmp_path):
    m = RaplMeter(root=str(tmp_path / "nope"))
    assert not m.available and m.begin() is None
    st = StageStats(map_wall_s=1.0)
    m.attribute(None, st)                                # no-op, no raise
    assert st.energy_j == 0.0 and st.energy_source == ""


def test_nvml_meter_unavailable_without_its_library():
    """No ``libnvidia-ml.so.1`` here: the meter is unavailable, begins no
    run and charges nothing (the card's test is in test_torch_cuda)."""
    import ctypes.util
    if ctypes.util.find_library("nvidia-ml"):   # pragma: no cover - card hosts
        pytest.skip("this host has NVML; test_torch_cuda checks the meter")
    m = NvmlMeter(index=0)
    assert not m.available and m.begin() is None
    st = StageStats(map_wall_s=1.0)
    m.attribute(None, st)
    assert st.energy_j == 0.0 and st.energy_source == ""


def test_pick_meter_resolution():
    assert pick_meter("null").name == "null"
    assert pick_meter("modeled").name == "modeled"
    assert pick_meter("rapl").name == "rapl"
    assert pick_meter("nvml").name == "nvml"
    assert pick_meter("auto").name in ("rapl", "nvml", "modeled")
    assert get_meter().name == "null"   # module default stays null


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

def _fill(reg):
    reg.counter("reqs").inc()
    reg.counter("reqs").inc(4)
    reg.gauge("depth").set(3.0)
    reg.gauge("depth").add(-1.0)
    h = reg.histogram("lat_ms")
    for v in range(1, 101):
        h.observe(float(v))
    return reg


def test_metrics_registry_counters_gauges_histograms():
    reg = _fill(MetricsRegistry())
    assert reg.counter("reqs").value == 5
    assert reg.gauge("depth").value == 2.0
    snap = reg.histogram("lat_ms").snapshot()
    assert snap["count"] == 100 and snap["min"] == 1.0 and snap["max"] == 100.0
    assert snap["p50"] == pytest.approx(50.0, abs=1.0)
    assert snap["p99"] == pytest.approx(99.0, abs=1.0)
    d = json.loads(reg.to_json())
    assert d["counters"]["reqs"] == 5
    text = reg.render_text()
    assert "reqs_total 5" in text and 'quantile="p99"' in text
    jreg = _fill(JO.MetricsRegistry())
    assert reg.to_dict() == jreg.to_dict()
    assert text == jreg.render_text()


def test_histogram_window_drops_oldest():
    h = Histogram("w", max_samples=10)
    for v in range(100):
        h.observe(float(v))
    snap = h.snapshot()
    assert snap["count"] == 100                 # total observations
    assert snap["min"] == 90.0                  # window keeps the newest
    assert Histogram("empty").snapshot()["count"] == 0
    jh = JO.Histogram("w", max_samples=10)
    for v in range(100):
        jh.observe(float(v))
    assert snap == jh.snapshot()
    assert [h.percentile(q) for q in (0, 50, 99, 100)] == \
        [jh.percentile(q) for q in (0, 50, 99, 100)]


def test_export_trace_script_cpu(tmp_path, monkeypatch, capsys):
    """``scripts/torch_export_trace.py --device cpu`` (the port of
    ``scripts/export_trace.py``) writes a trace that loads as JSON and
    holds every span family, with no span left open and one lane span a
    split."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "scripts" / \
        "torch_export_trace.py"
    spec = importlib.util.spec_from_file_location("torch_export_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    made = []

    class Recorded(Tracer):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(mod, "Tracer", Recorded)
    out = tmp_path / "trace.json"
    assert mod.main([str(out), "--device", "cpu"]) == 0
    (tr,) = made
    assert tr.open_spans == 0
    doc = json.loads(out.read_text())
    names = [e["name"] for e in doc["traceEvents"]]
    assert mod.REQUIRED_SPANS <= set(names)
    assert names.count("lane-exec") == 8 and names.count("job") == 1
    printed = capsys.readouterr().out
    assert "lane-exec" in printed and "modeled:" in printed
