"""The JAX package's per-device argument bytes of each live dry-run cell, from
its abstract state alone (no lowering, no compile), on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/reference_dryrun_bytes.py \
        [--mesh single|multi|both] [--mode baseline|optimized] [--out FILE]

For each live (architecture, shape) cell and mesh it builds what the
reference's ``launch/dryrun.py::build_lowering`` hands to ``lower``: the
train state of ``make_train_step`` (``rc_for_mode``'s micro-batches and
knobs), or the parameters and router biases (and, for decode, the cache)
sharded by its rules, plus ``input_specs``'s batch, each with its
``NamedSharding`` over 512 host devices, and sums ``shard_shape`` bytes of
every leaf: the bytes one device holds as arguments. It prints one JSON
object a cell (``cell``, ``argument_bytes_per_device``) and writes them all
to ``--out``. ``PERF.md`` sets these beside the port's dry run
(``src/repro_torch/launch/dryrun.py``); nothing here runs on a card.
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.argv[1:1] = ["--devices", "512"]     # the reference's dry run reads it
from repro.launch import dryrun as jdr  # noqa: E402

del sys.argv[1:3]

import argparse  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.configs import live_cells  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models import model as mdl  # noqa: E402
from repro.parallel.sharding import make_rules, spec_for, use_mesh  # noqa: E402
from repro.training.step import make_train_step  # noqa: E402


def shard_bytes(tree) -> int:
    return sum(int(np.prod(x.sharding.shard_shape(x.shape)))
               * x.dtype.itemsize for x in jax.tree.leaves(tree))


def cell_args(cfg, shape, mesh, rc):
    """The abstract arguments ``build_lowering`` lowers the cell's step on."""
    if shape.kind == "train":
        _, st_abs, st_sh, rules = make_train_step(cfg, rc, mesh)
        state = jax.tree.map(lambda a, s: jax.ShapeDtypeStruct(
            a.shape, a.dtype, sharding=s), st_abs, st_sh)
        return state, mdl.input_specs(cfg, shape, mesh, rules)
    rules = make_rules(mesh, pod_param_mode=rc.pod_param_mode)
    params = jdr._abstract_params_sharded(cfg, mesh, rules)
    batch = mdl.input_specs(cfg, shape, mesh, rules)
    if shape.kind == "prefill":
        return params, batch
    cache = jdr._abstract_cache_sharded(cfg, mesh, rules, shape.global_batch,
                                        shape.seq_len)
    with use_mesh(mesh, rules):
        tok = jax.ShapeDtypeStruct(
            (shape.global_batch, 1), jnp.int32, sharding=NamedSharding(
                mesh, spec_for((shape.global_batch, 1), ("batch", None),
                               mesh, rules)))
    return params, cache, tok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mode", default="baseline",
                    choices=["baseline", "optimized"])
    ap.add_argument("--out", default="artifacts/reference_dryrun_bytes.json")
    args = ap.parse_args(argv)
    kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out = {}
    for kind in kinds:
        mesh = make_production_mesh(multi_pod=kind == "multi")
        name = {"single": "16x16", "multi": "2x16x16"}[kind]
        for cfg, shape in live_cells():
            rc = jdr.rc_for_mode(cfg, shape, args.mode)
            cell = f"{cfg.name}__{shape.name}__{name}__{args.mode}"
            rec = {"cell": cell, "argument_bytes_per_device":
                   shard_bytes(cell_args(cfg, shape, mesh, rc))}
            out[cell] = rec
            print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
