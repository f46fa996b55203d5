"""Carry the resident shuffle state across frameworks as numpy arrays.

This system has no weights; its state is the tiered shuffle output that a
``ResidentCatalog`` keeps on the device. ``catalog_to_numpy`` writes it as a
dict of numpy arrays and plain numbers, and ``catalog_from_numpy`` rebuilds
a ``ResidentCatalog`` from such a dict on a device, so the port's reduce can
run on tiers another implementation produced (the JAX package's, in the
tests). The dict:

    {"P": int, "codec": str, "tile": int, "pad_value": float,
     "zone_radius": float, "zone_height": float,
     "n_rows": int, "d": int,
     "n_owned": [P] int, "n_bucket": [P] int,
     "tiers": [{"part_ids": [Pt] int, "owned_wire": (arrays [Pt, C1, ...]),
                "bucket_wire": (arrays [Pt, C2, ...]),
                "n_owned": [Pt] int, "n_bucket": [Pt] int,
                "C1": int, "C2": int, "Pt": int}, ...]}

The partitioner is a ``ZonePartitioner(zone_radius, zone_height)``, the only
partitioner of the jobs this package runs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.mapreduce.codecs import get_codec
from repro_torch.mapreduce.job import (DeviceShuffledData, ResidentCatalog,
                                       TierData, resolve_device)
from repro_torch.mapreduce.zones import ZonePartitioner


def _check_tier(k: int, t: dict, codec) -> None:
    Pt, C1, C2 = int(t["Pt"]), int(t["C1"]), int(t["C2"])
    ow, bw = tuple(t["owned_wire"]), tuple(t["bucket_wire"])
    want = len(codec.encode_device(torch.zeros(1, 3)))
    if len(ow) != want or len(bw) != want:
        raise ValueError(f"tier {k}: codec {codec.name!r} has {want} wire "
                         f"arrays, got {len(ow)} owned and {len(bw)} bucket")
    for name, ws, C in (("owned_wire", ow, C1), ("bucket_wire", bw, C2)):
        for w in ws:
            if tuple(np.shape(w)[:2]) != (Pt, C):
                raise ValueError(f"tier {k}: {name} leading dims "
                                 f"{tuple(np.shape(w)[:2])} != {(Pt, C)}")
    for name, C in (("n_owned", C1), ("n_bucket", C2)):
        n = np.asarray(t[name])
        if n.shape != (Pt,) or (Pt and (n.min() < 0 or n.max() > C)):
            raise ValueError(f"tier {k}: {name} must be [{Pt}] counts in "
                             f"0..{C}")


def catalog_from_numpy(d: dict, device=None) -> ResidentCatalog:
    """Rebuild a ``ResidentCatalog`` on ``device`` (``None`` = the card)
    from the dict described in the module docstring."""
    device = resolve_device(device)
    codec = get_codec(d["codec"])

    def put(a, dtype=None):
        return torch.as_tensor(np.array(a, dtype), device=device)   # a copy

    tiers = []
    for k, t in enumerate(d["tiers"]):
        _check_tier(k, t, codec)
        tiers.append(TierData(
            np.asarray(t["part_ids"], np.int64),
            tuple(put(w) for w in t["owned_wire"]),
            tuple(put(w) for w in t["bucket_wire"]),
            put(t["n_owned"], np.int32), put(t["n_bucket"], np.int32),
            C1=int(t["C1"]), C2=int(t["C2"]), Pt=int(t["Pt"])))
    sd = DeviceShuffledData(tiers, np.asarray(d["n_owned"], np.int64),
                            np.asarray(d["n_bucket"], np.int64))
    part = ZonePartitioner(float(d["zone_radius"]),
                           float(d.get("zone_height", 0.0)))
    return ResidentCatalog(part, codec, int(d["tile"]),
                           float(d.get("pad_value", 0.0)), sd, int(d["P"]),
                           device, n_rows=int(d.get("n_rows", 0)),
                           d=int(d.get("d", 3)))


def catalog_to_numpy(cat: ResidentCatalog) -> dict:
    """The reverse of ``catalog_from_numpy``: host copies of every tier."""
    if not isinstance(cat.partitioner, ZonePartitioner):
        raise TypeError("catalog_to_numpy writes ZonePartitioner catalogs, "
                        f"got {type(cat.partitioner).__name__}")
    return {
        "P": cat.P, "codec": cat.codec.name, "tile": cat.tile,
        "pad_value": cat.pad_value,
        "zone_radius": cat.partitioner.radius,
        "zone_height": cat.partitioner.zone_height,
        "n_rows": cat.n_rows, "d": cat.d,
        "n_owned": np.asarray(cat.sd.n_owned),
        "n_bucket": np.asarray(cat.sd.n_bucket),
        "tiers": [{
            "part_ids": np.asarray(t.part_ids),
            "owned_wire": tuple(w.cpu().numpy() for w in t.owned_wire),
            "bucket_wire": tuple(w.cpu().numpy() for w in t.bucket_wire),
            "n_owned": t.n_owned.cpu().numpy(),
            "n_bucket": t.n_bucket.cpu().numpy(),
            "C1": t.C1, "C2": t.C2, "Pt": t.Pt,
        } for t in cat.sd.tiers],
    }
