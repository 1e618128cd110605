"""Multi-pod dry run of the port: every (arch x shape x mesh) cell's trees
on the ``meta`` device, with their partition specs and per-device bytes.

Counterpart of the JAX package's ``launch/dryrun.py``.  For each cell this
driver
  1. takes the production mesh's config (16x16 single-pod / 2x16x16
     multi-pod, ``launch.mesh.mesh_config``); no device is touched,
  2. builds the step's trees on the ``meta`` device (zero allocation):
     the params, the AdamW state for ``train``, the batch, the cache for
     ``decode`` and the logits a serving step returns,
  3. resolves each tree's specs (``models/factory.py``, ZeRO-1 from
     ``training/optimizer.py``) and checks each leaf divides its axes,
  4. reports each leaf's spec, each tree's bytes in all and on one
     device (a leaf's bytes over the product of the mesh axes its spec
     names), and the config's ``params`` and ``active_params``,
  5. writes one JSON record a cell to ``experiments/dryrun_torch/`` (or
     ``--out``), a directory ``.gitignore`` lists.

What the port's dry run does not compute: the reference lowers and
compiles each cell with XLA and reads ``memory_analysis`` (temp bytes),
``cost_analysis`` (FLOPs) and the post-SPMD HLO (collective bytes), and
times the compile.  PyTorch runs eagerly and has no such compiler pass,
so temp bytes, FLOPs, collective bytes and compile time are left out
(each record lists them under ``not_computed``); the per-device bytes
come from the meta-device trees and the specs, in place of XLA's
argument and output sizes.

The cells cover the port's registered archs (stablelm-3b,
qwen3-moe-30b-a3b, phi3.5-moe-42b-a6.6b); ``long_500k`` is ``skipped`` on
them, as the reference skips it on every full-attention arch.  The
variants: ``--no-tp`` (replicated model-axis weights) and
``--decode-seq-shard`` (the KV sequence over the model axis) change the
specs (``--no-tp`` the params' bytes a device; ``--decode-seq-shard``
moves the cache's model split from its head dim to its sequence, the
same bytes a device at the assigned shapes); ``--two-phase-moe`` (a ``ParallelPlan`` over the
mesh, recorded with its shards), ``--attn-threshold``, ``--ssm-chunk``
and ``--remat`` change no tree and are recorded.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
      --arch stablelm-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both   # all cells
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import MeshConfig, TrainConfig
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.launch.mesh import _mk, mesh_config
from repro_torch.models import factory, transformer
from repro_torch.models.layers import torch_dtype
from repro_torch.sharding.partitioning import (ParallelPlan, PartitionSpec,
                                               shards_of, to_pspec,
                                               validate_pspec)
from repro_torch.training import optimizer as opt_mod

REPO_ROOT = Path(__file__).resolve().parents[3]
OUT_DIR = REPO_ROOT / "experiments" / "dryrun_torch"
NOT_COMPUTED = ("temp_bytes", "flops", "collective_bytes", "compile_s")
NO_TP_RULES = {"d_inner": (), "ssm_heads": (), "qkv": (), "mlp": (),
               "state": ()}


def meta_plan(mesh_cfg: MeshConfig) -> ParallelPlan:
    """A ``ParallelPlan`` over a mesh of the config's shape whose every
    shard is the ``meta`` device (the plan's axes, no device)."""
    mesh = _mk(mesh_cfg.shape, mesh_cfg.axis_names,
               devices=["meta"] * mesh_cfg.n_devices)
    return ParallelPlan(mesh=mesh, dp_axes=mesh_cfg.dp_axes,
                        model_axis="model")


def build_cell(cfg, shape, mesh_cfg: MeshConfig, train_cfg: TrainConfig,
               variant: Optional[dict] = None) -> dict:
    """{tree name: (tree of meta tensors, tree of PartitionSpecs)} for one
    cell, plus "plan" (a ``ParallelPlan`` or None).

    ``variant``: the reference's knobs -- two_phase_moe (the plan of the
    two-phase MoE), decode_seq_shard (the KV sequence over the model
    axis), no_tp (replicated model-axis weights); the others change no
    tree."""
    variant = variant or {}
    plan = meta_plan(mesh_cfg) if variant.get("two_phase_moe") and \
        cfg.moe is not None else None
    rules = NO_TP_RULES if variant.get("no_tp") else None

    p_shape = transformer.init_params(cfg, device="meta")
    trees = {"params": (p_shape, factory.param_pspecs(cfg, mesh_cfg,
                                                      p_shape, rules=rules)),
             "batch": (factory.make_batch(cfg, shape, abstract=True),
                       factory.batch_pspecs(cfg, shape, mesh_cfg))}
    if shape.kind == "train":
        trees["opt_state"] = (opt_mod.init_opt_state(p_shape),
                              opt_mod.opt_state_pspecs(
                                  trees["params"][1], p_shape, mesh_cfg,
                                  zero1=train_cfg.zero1))
    else:
        B = shape.global_batch
        trees["logits"] = (
            torch.empty((B, cfg.vocab_size), dtype=torch_dtype(cfg),
                        device="meta"),
            to_pspec(("batch", "vocab"), mesh_cfg,
                     shape=(B, cfg.vocab_size)))
    if shape.kind == "decode":
        factory.DECODE_SEQ_SHARD = bool(variant.get("decode_seq_shard"))
        try:
            trees["cache"] = (factory.cache_shapes(cfg, shape),
                              factory.cache_pspecs(cfg, shape, mesh_cfg))
        finally:
            factory.DECODE_SEQ_SHARD = False
    trees["plan"] = plan
    return trees


def tree_bytes(tree, specs, mesh_cfg: MeshConfig) -> Dict[str, int]:
    """{"total", "per_device", "leaves"} of a tree of meta tensors under
    its specs (host ints, such as the cache's length, are no bytes)."""
    spec_leaves = T.leaves(specs) if not isinstance(specs, PartitionSpec) \
        else [specs]
    total = per_device = n = 0
    for t, spec in zip(T.leaves(tree), spec_leaves):
        if not isinstance(t, torch.Tensor):
            continue
        validate_pspec(spec, t.shape, mesh_cfg)
        b = t.numel() * t.element_size()
        total += b
        per_device += b // shards_of(spec, mesh_cfg)
        n += 1
    return {"total": total, "per_device": per_device, "leaves": n}


def tree_specs(specs) -> Dict[str, list]:
    """{leaf path: its spec's entries} of a tree of PartitionSpecs (a
    tuple of names as a list), for the JSON record."""
    flat = [("", specs)] if isinstance(specs, PartitionSpec) \
        else T.flatten(specs)
    return {path: [list(e) if isinstance(e, tuple) else e for e in spec]
            for path, spec in flat}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             train_cfg: Optional[TrainConfig] = None, tag: str = "baseline",
             cfg=None, variant: Optional[dict] = None) -> dict:
    cfg = cfg or get_config(arch_id)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    rec = {"arch": arch_id, "shape": shape_name,
           "mesh": "multi" if multi_pod else "single", "tag": tag}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    variant = variant or {}
    remat = variant.get("remat") or "dots"
    train_cfg = train_cfg or TrainConfig(remat=remat, zero1=True)
    mesh_cfg = mesh_config(multi_pod=multi_pod)
    trees = build_cell(cfg, shape, mesh_cfg, train_cfg, variant=variant)
    plan = trees.pop("plan")
    bytes_ = {name: tree_bytes(tree, specs, mesh_cfg)
              for name, (tree, specs) in trees.items()}
    rec.update(
        status="ok",
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        kind=shape.kind,
        n_devices=mesh_cfg.n_devices,
        params=cfg.param_count(),
        active_params=cfg.active_param_count(),
        bytes=bytes_,
        specs={name: tree_specs(specs) for name, (_, specs) in trees.items()},
        per_device_bytes=sum(b["per_device"] for b in bytes_.values()),
        variant={k: v for k, v in variant.items() if v},
        remat=train_cfg.remat,
        zero1=train_cfg.zero1,
        not_computed=list(NOT_COMPUTED),
    )
    if plan is not None:
        rec["plan"] = {"dp_axes": list(plan.dp_axes),
                       "model_axis": plan.model_axis,
                       "dp_total": plan.dp_total,
                       "experts_per_shard": cfg.moe.num_experts //
                       plan.mesh.shape[plan.model_axis]}
    return rec


def save_record(rec: dict, out_dir: Path = OUT_DIR) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = f"{rec['mesh']}__{rec['arch']}__{rec['shape']}__{rec['tag']}"
    path = out_dir / f"{stem}.json"
    path.write_text(json.dumps(rec, indent=2))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the records")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--two-phase-moe", action="store_true")
    ap.add_argument("--attn-threshold", type=int, default=0)
    ap.add_argument("--decode-seq-shard", action="store_true")
    ap.add_argument("--ssm-chunk", type=int, default=0)
    ap.add_argument("--no-tp", action="store_true")
    ap.add_argument("--remat", default="", choices=("", "none", "dots",
                                                    "full"))
    args = ap.parse_args(argv)
    variant = {"two_phase_moe": args.two_phase_moe,
               "attn_threshold": args.attn_threshold,
               "decode_seq_shard": args.decode_seq_shard,
               "ssm_chunk": args.ssm_chunk,
               "no_tp": args.no_tp,
               "remat": args.remat}
    out_dir = Path(args.out)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                mesh_name = "multi" if multi else "single"
                out = out_dir / f"{mesh_name}__{arch}__{shape}__{args.tag}.json"
                if args.skip_existing and out.exists():
                    prev = json.loads(out.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[skip] {mesh_name} {arch} {shape} (cached)")
                        continue
                print(f"[cell] mesh={mesh_name} arch={arch} shape={shape} "
                      "...", flush=True)
                try:
                    rec = run_cell(arch, shape, multi, tag=args.tag,
                                   variant=variant)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "tag": args.tag, "status": "error",
                           "error": repr(e)[:2000]}
                    failures += 1
                save_record(rec, out_dir)
                if rec["status"] == "ok":
                    b = rec["bytes"]
                    print("  ok: bytes a device " + ", ".join(
                        f"{name} {v['per_device']:.4e}"
                        for name, v in b.items())
                        + f"; in all {rec['per_device_bytes']:.4e} "
                        f"({rec['params']} params, {rec['active_params']} "
                        "active)", flush=True)
                elif rec["status"] == "skipped":
                    print(f"  skipped: {rec['reason']}", flush=True)
    print(f"done, failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
