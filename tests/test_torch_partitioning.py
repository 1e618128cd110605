"""The port's partition plan against the JAX package's.

Specs are pure functions of a config, a shape and a mesh, so both
packages run in this process with no device: every PartitionSpec is
compared as the tuple of its entries.  ``to_pspec`` (with its audit),
``zero1_pspec`` and ``validate_pspec`` over a seeded table of logical
tuples and shapes on the single-pod, multi-pod and (4, 2) meshes; the
three archs the port registers at full width, leaf by leaf, from the
port's ``param_shapes`` (meta device) and the reference's
``jax.eval_shape``: params, AdamW state with and without ZeRO-1, every
shape's batch and decode cache with and without ``DECODE_SEQ_SHARD`` (the
reference's cache has one more axis, its ``n_attn_per_unit`` at 1: its
spec is compared with that entry deleted); ``shape_applicable``;
``plan_mesh`` and ``replan_after_failure`` over the reference's grid
(``tests/test_runtime.py``) and ``replan_event``; and the dry run's
records for the three archs x four shapes x both production meshes,
whose per-device bytes equal those the reference's specs give its own
abstract trees.
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import MeshConfig as JMesh
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import get_config as jget
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import shape_applicable as jshape_applicable
from repro.models import factory as jfactory
from repro.models import transformer as jtransformer
from repro.runtime import elastic as jelastic
from repro.sharding import partitioning as jpart
from repro.training import optimizer as jopt
from repro_torch import tree as T
from repro_torch.configs.base import MeshConfig
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import (ALL_SHAPE_NAMES, SHAPES,
                                        ShapeConfig, shape_applicable)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import factory, transformer
from repro_torch.runtime import elastic
from repro_torch.sharding import partitioning as part
from repro_torch.training import optimizer as opt

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": (1, 16, 16), "multi": (2, 16, 16), "4x2": (1, 4, 2)}
FULL = ("single", "multi")


def meshes(name):
    pods, data, model = MESHES[name]
    return (MeshConfig(data=data, model=model, pods=pods),
            JMesh(data=data, model=model, pods=pods))


def jleaves(tree):
    return jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def tuples(specs):
    return [tuple(s) for s in specs]


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch(request):
    """One registered arch at full width in both packages, with the
    reference's abstract params."""
    a = request.param
    jcfg = jget(a)
    return dict(arch=a, cfg=get_config(a), jcfg=jcfg,
                shapes=transformer.init_params(get_config(a), device="meta"),
                jshapes=jax.eval_shape(lambda: jtransformer.init_params(
                    jax.random.PRNGKey(0), jcfg)))


# ------------------------------------------------------------------ rules

LOGICALS = [("batch", "seq"), ("batch", "seq", "embed"), ("embed", "qkv"),
            ("qkv", "embed"), ("layers", "experts", "embed", "mlp"),
            ("layers", "embed", "experts"), ("vocab", "embed"),
            ("embed", "vocab"), ("blocks", "batch", "kv_seq", "kv_heads",
                                 "kv_hd"),
            ("heads", "head_dim"), ("kv_heads", "kv_hd"), ("zero1", "mlp"),
            ("batch", "batch"), ("d_inner", "state"), ("ssm_heads", None),
            (None, "mlp"), ("frames", "patches", "conv"), ("batch",), ()]
DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 96, 128, 512, 1000)
RULES = (None, {"kv_seq": ("dp",)}, {"kv_seq": ("dp", "model"), "kv_hd": ()},
         {"qkv": (), "mlp": ()})


def _cases(seed):
    rng = np.random.default_rng(seed)
    for lg in LOGICALS:
        for _ in range(6):
            yield lg, tuple(int(d) for d in rng.choice(DIMS, len(lg))), \
                RULES[int(rng.integers(len(RULES)))]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_to_pspec_zero1_validate_match_jax(mesh):
    m, jm = meshes(mesh)
    for lg, shape, rules in _cases(len(mesh)):
        audit, jaudit = [], []
        got = part.to_pspec(lg, m, shape=shape, rules=rules, audit=audit)
        want = jpart.to_pspec(lg, jm, shape=shape, rules=rules, audit=jaudit)
        assert tuple(got) == tuple(want), (lg, shape, rules)
        assert audit == jaudit
        assert tuple(part.to_pspec(lg, m, rules=rules)) == \
            tuple(jpart.to_pspec(lg, jm, rules=rules))
        z, jz = part.zero1_pspec(got, shape, m), \
            jpart.zero1_pspec(want, shape, jm)
        assert tuple(z) == tuple(jz), (lg, shape)
        # an arbitrary spec: both raise, or neither
        for spec in (got, z, part.PartitionSpec(*(["data"] * len(shape)))):
            jspec = jax.sharding.PartitionSpec(*spec)
            errs = []
            for fn, s, mm in ((part.validate_pspec, spec, m),
                              (jpart.validate_pspec, jspec, jm)):
                try:
                    fn(s, shape, mm)
                    errs.append(None)
                except ValueError:
                    errs.append("raised")
            assert errs[0] == errs[1], (spec, shape)


def test_partition_spec_value():
    s = part.PartitionSpec("data", None, ("pod", "data"))
    assert tuple(s) == ("data", None, ("pod", "data")) and len(s) == 3
    assert s == part.PartitionSpec("data", None, ("pod", "data"))
    assert s != part.PartitionSpec("data") and hash(s) == hash(
        part.PartitionSpec("data", None, ("pod", "data")))
    assert repr(part.PartitionSpec()) == "PartitionSpec()"
    with pytest.raises(AttributeError):
        s._entries = ()
    with pytest.raises(TypeError):
        part.PartitionSpec(3)
    assert T.leaves({"a": s}) == [s]           # one leaf of a port tree
    assert part.DEFAULT_RULES == jpart.DEFAULT_RULES


@pytest.mark.parametrize("shape", [(1, 8), (4, 2), (2, 2, 2)])
def test_parallel_plan_over_a_local_mesh(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    mesh = make_local_mesh(shape, "cpu", axes=axes)
    assert mesh.shape == dict(zip(axes, shape)) and mesh.size == \
        int(np.prod(shape))
    plan = part.ParallelPlan(mesh=mesh, dp_axes=axes[:-1])
    assert plan.dp_total == int(np.prod(shape[:-1]))
    assert plan.model_axis == "model"
    assert mesh.device_at({"model": shape[-1] - 1}) == torch.device("cpu")
    with pytest.raises(KeyError):
        mesh.device_at({"expert": 0})
    assert make_local_mesh(3, "cpu").shape == {"data": 3}


# ------------------------------------------------------------------ trees


def test_logical_trees_match_jax(arch):
    got = _logicals(transformer.params_logical(arch["cfg"]))
    want = jax.tree.leaves(jtransformer.params_logical(arch["jcfg"]),
                           is_leaf=part.is_logical)
    assert got == want and len(got) == len(T.leaves(arch["shapes"]))
    for lg, shape in zip(got, T.leaves(arch["shapes"])):
        assert len(lg) == shape.ndim
    jc = jtransformer.cache_logical(arch["jcfg"])
    pc = transformer.cache_logical(arch["cfg"])
    # no k and v without attention (mamba2), as in the reference; the SSM
    # state's specs are the reference's
    if jc.kv_k is None:
        assert pc.kv_k is None and pc.kv_v is None
    else:
        assert pc.kv_k == jc.kv_k[:1] + jc.kv_k[2:] and pc.kv_v == pc.kv_k
    assert (pc.ssm is None) == (jc.ssm is None)
    if pc.ssm is not None:
        assert tuple(pc.ssm) == tuple(jc.ssm)
    assert pc.pos == jc.pos and pc.length == ()


def _logicals(tree):
    """A logical tree's leaves in the reference's order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _logicals(tree[k])]
    return [tree]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_and_opt_state_specs_match_jax(arch, mesh):
    m, jm = meshes(mesh)
    got = factory.param_pspecs(arch["cfg"], m, arch["shapes"])
    want = jfactory.param_pspecs(arch["jcfg"], jm, arch["jshapes"])
    assert [p for p, _ in T.flatten(arch["shapes"])] == \
        ["/".join(k.key for k in path) for path, _ in
         jax.tree_util.tree_flatten_with_path(arch["jshapes"])[0]]
    assert tuples(T.leaves(got)) == tuples(jleaves(want))
    for leaf, spec in zip(T.leaves(arch["shapes"]), T.leaves(got)):
        part.validate_pspec(spec, leaf.shape, m)
    assert tuples(T.leaves(factory.param_pspecs(
        arch["cfg"], m, transformer.param_shapes(arch["cfg"])))) == \
        tuples(T.leaves(got))
    assert tuples(T.leaves(factory.param_pspecs(arch["cfg"], m))) == \
        tuples(jleaves(jfactory.param_pspecs(arch["jcfg"], jm)))
    for zero1 in (True, False):
        o = opt.opt_state_pspecs(got, arch["shapes"], m, zero1=zero1)
        jo = jopt.opt_state_pspecs(want, arch["jshapes"], jm, zero1=zero1)
        assert tuple(o.step) == tuple(jo.step) == ()
        assert tuples(T.leaves(o.mu)) == tuples(jleaves(jo.mu))
        assert tuples(T.leaves(o.nu)) == tuples(jleaves(jo.nu))


@pytest.mark.parametrize("seq_shard", (False, True))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_cache_specs_match_jax(arch, mesh, seq_shard,
                                         monkeypatch):
    m, jm = meshes(mesh)
    monkeypatch.setattr(factory, "DECODE_SEQ_SHARD", seq_shard)
    monkeypatch.setattr(jfactory, "DECODE_SEQ_SHARD", seq_shard)
    for name in ALL_SHAPE_NAMES:
        shape, jshape = SHAPES[name], JSHAPES[name]
        b = factory.batch_pspecs(arch["cfg"], shape, m)
        jb = jfactory.batch_pspecs(arch["jcfg"], jshape, jm)
        assert sorted(b) == sorted(jb)
        assert all(tuple(b[k]) == tuple(jb[k]) for k in b), name
        if not shape.is_decode:
            continue
        c = factory.cache_pspecs(arch["cfg"], shape, m)
        jc = jfactory.cache_pspecs(arch["jcfg"], jshape, jm)
        cs = factory.cache_shapes(arch["cfg"], shape)
        jcs = jfactory.cache_shapes(arch["jcfg"], jshape)
        if jc.kv_k is None:
            assert c.kv_k is None and cs.kv_k is None
        else:
            for got, want in ((c.kv_k, jc.kv_k), (c.kv_v, jc.kv_v)):
                w = tuple(want)
                assert tuple(got) == w[:1] + w[2:], (name, got, want)
            assert cs.kv_k.device.type == "meta"
            assert tuple(cs.kv_k.shape) == jcs.kv_k.shape[:1] + \
                jcs.kv_k.shape[2:] and jcs.kv_k.shape[1] == 1
        assert (c.ssm is None) == (jc.ssm is None)
        if c.ssm is not None:
            # the SSM state keeps the reference's (units, SSD mixers) axes
            assert tuples(c.ssm) == tuples(jc.ssm), name
            assert [tuple(t.shape) for t in cs.ssm] == \
                [t.shape for t in jcs.ssm]
        assert tuple(c.pos) == tuple(jc.pos) and tuple(c.length) == ()


def test_make_batch_abstract_and_drawn():
    cfg = get_config("qwen3-moe-30b-a3b")
    for name, shape in SHAPES.items():
        b = factory.make_batch(cfg, shape, abstract=True)
        jb = jfactory.make_batch(jget(cfg.arch_id), JSHAPES[name],
                                 abstract=True)
        assert sorted(b) == sorted(jb)
        for k, t in b.items():
            assert t.device.type == "meta" and t.dtype == torch.int32
            assert tuple(t.shape) == jb[k].shape
    small = ShapeConfig("s", seq_len=16, global_batch=2, kind="train")
    g = torch.Generator().manual_seed(0)
    b = factory.make_batch(cfg, small, abstract=False, generator=g,
                           device="cpu")
    assert b["tokens"].shape == (2, 16) and b["targets"].dtype == torch.int32
    assert int(b["tokens"].min()) >= 0 and \
        int(b["tokens"].max()) < cfg.vocab_size
    again = factory.make_batch(cfg, small, abstract=False,
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    assert torch.equal(b["tokens"], again["tokens"])
    with pytest.raises(ValueError, match="generator"):
        factory.make_batch(cfg, small, abstract=False, device="cpu")


# ------------------------------------------------------------------ shapes


def test_shapes_and_applicability_match_jax():
    assert ALL_SHAPE_NAMES == tuple(JSHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(JSHAPES[name])
        assert (shape.tokens, shape.is_decode) == (JSHAPES[name].tokens,
                                                   JSHAPES[name].is_decode)
    for a in JARCHS:          # duck-typed: the rule reads sub_quadratic
        for name in SHAPES:
            assert shape_applicable(jget(a), SHAPES[name]) == \
                jshape_applicable(jget(a), JSHAPES[name])
    for a in ARCHS:
        # long_500k: the sub-quadratic SSM and hybrid archs only
        ok, reason = shape_applicable(get_config(a), SHAPES["long_500k"])
        sub_quadratic = a in ("mamba2-780m", "jamba-1.5-large-398b")
        assert get_config(a).sub_quadratic == sub_quadratic
        assert ok == sub_quadratic and \
            ("full-attention" in reason) == (not sub_quadratic)


# ------------------------------------------------------------------ elastic


def _plan_tuple(p):
    if p is None:
        return None
    return (dataclasses.asdict(p.mesh), p.microbatch_multiplier,
            p.dropped_chips)


@pytest.mark.parametrize("target", [(16, 16, 2), (16, 16, 1), (4, 2, 1)])
def test_plan_mesh_and_replan_match_jax(target):
    data, model, pods = target
    m, jm = MeshConfig(data, model, pods), JMesh(data, model, pods)
    for avail in range(0, m.n_devices + 9, 3):
        for batch in (1, 32, 128, 256):
            got = elastic.plan_mesh(avail, m, batch)
            assert _plan_tuple(got) == \
                _plan_tuple(jelastic.plan_mesh(avail, jm, batch)), \
                (avail, batch)
            if got is not None and batch > 1:   # the reference's properties
                assert got.mesh.model == model
                assert got.mesh.n_devices <= avail
                assert batch % (got.mesh.data * got.mesh.pods) == 0
    for failed in range(0, m.n_devices + 1, 7):
        assert _plan_tuple(elastic.replan_after_failure(m, failed, 256)) == \
            _plan_tuple(jelastic.replan_after_failure(jm, failed, 256))


def test_reference_grid_and_replan_event():
    target = MeshConfig(data=16, model=16, pods=2)
    plan = elastic.plan_mesh(512, target, global_batch=256)
    assert plan.mesh == target and plan.microbatch_multiplier == 1 and \
        plan.dropped_chips == 0
    plan = elastic.plan_mesh(504, target, global_batch=256)
    assert plan.mesh.model == 16 and plan.mesh.n_devices <= 504
    assert elastic.plan_mesh(8, target, 256) is None
    assert elastic.replan_after_failure(target, 256, 256).mesh.n_devices \
        <= 256
    jt = JMesh(data=16, model=16, pods=2)
    for p, jp in ((plan, jelastic.plan_mesh(504, jt, 256)), (None, None)):
        e = elastic.replan_event(p, 7, "runner")
        je = jelastic.replan_event(jp, 7, "runner")
        assert tuple(e) == tuple(je) and e.kind == "elastic_replan"
    assert elastic.replan_event(None, 3).get("feasible") is False


# ------------------------------------------------------------------ dry run


def _jax_bytes(tree, specs, jm):
    total = per = 0
    for leaf, spec in zip(jax.tree.leaves(tree), jleaves(specs)):
        b = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        total += b
        n = 1
        for e in spec:
            for a in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                n *= jpart.mesh_axis_size(jm, a)
        per += b // n
    return total, per


@pytest.mark.parametrize("mesh", FULL)
def test_dry_run_records_match_jax_specs(arch, mesh):
    """Each cell's trees and per-device bytes: the reference's specs on its
    own abstract trees give the same numbers (its cache's extra axis has
    size 1, so no byte)."""
    multi = mesh == "multi"
    _, jm = meshes(mesh)
    jcfg = arch["jcfg"]
    for name in ALL_SHAPE_NAMES:
        rec = dryrun.run_cell(arch["arch"], name, multi)
        assert rec["mesh"] == mesh and rec["shape"] == name
        ok, reason = jshape_applicable(jcfg, JSHAPES[name])
        # long_500k runs for the sub-quadratic archs (mamba2, jamba) only
        assert ok == (name != "long_500k" or jcfg.sub_quadratic)
        if not ok:
            assert rec["status"] == "skipped"
            assert rec["reason"] == reason
            continue
        shape = JSHAPES[name]
        assert rec["status"] == "ok" and rec["kind"] == shape.kind
        assert rec["n_devices"] == jm.n_devices
        assert (rec["params"], rec["active_params"]) == \
            (jcfg.param_count(), jcfg.active_param_count())
        assert rec["not_computed"] == list(dryrun.NOT_COMPUTED)
        p_specs = jfactory.param_pspecs(jcfg, jm, arch["jshapes"])
        want = {"params": _jax_bytes(arch["jshapes"], p_specs, jm),
                "batch": _jax_bytes(
                    jfactory.make_batch(jcfg, shape, abstract=True),
                    jfactory.batch_pspecs(jcfg, shape, jm), jm)}
        if shape.kind == "train":
            o = jax.eval_shape(jopt.init_opt_state, arch["jshapes"])
            want["opt_state"] = _jax_bytes(
                o, jopt.opt_state_pspecs(p_specs, arch["jshapes"], jm), jm)
        else:
            lg = jax.ShapeDtypeStruct((shape.global_batch, jcfg.vocab_size),
                                      jax.numpy.dtype(jcfg.dtype))
            want["logits"] = _jax_bytes(lg, jpart.to_pspec(
                ("batch", "vocab"), jm, shape=lg.shape), jm)
        if shape.kind == "decode":
            want["cache"] = _jax_bytes(
                jfactory.cache_shapes(jcfg, shape),
                jfactory.cache_pspecs(jcfg, shape, jm), jm)
        got = {k: (v["total"], v["per_device"])
               for k, v in rec["bytes"].items()}
        assert got == want, name
        assert rec["per_device_bytes"] == sum(v[1] for v in want.values())


def test_dry_run_variants_change_the_bytes_they_should():
    """--decode-seq-shard moves the cache's model split from its head dim
    to its sequence (the same bytes a device at these shapes); --no-tp
    replicates the model-axis weights; the plan and remat are recorded."""
    base = dryrun.run_cell("qwen3-moe-30b-a3b", "decode_32k", False)
    seq = dryrun.run_cell("qwen3-moe-30b-a3b", "decode_32k", False,
                          variant={"decode_seq_shard": True})
    assert base["specs"]["cache"]["kv_k"] == [None, "data", None, None,
                                              "model"]
    assert seq["specs"]["cache"]["kv_k"] == [None, "data", "model"]
    assert seq["bytes"] == base["bytes"]
    assert seq["variant"] == {"decode_seq_shard": True}
    no_tp = dryrun.run_cell("stablelm-3b", "train_4k", False,
                            variant={"no_tp": True})
    tp = dryrun.run_cell("stablelm-3b", "train_4k", False)
    assert no_tp["bytes"]["params"]["per_device"] > \
        tp["bytes"]["params"]["per_device"]
    two = dryrun.run_cell("qwen3-moe-30b-a3b", "train_4k", True,
                          variant={"two_phase_moe": True, "remat": "full"})
    assert two["plan"] == {"dp_axes": ["pod", "data"], "model_axis": "model",
                           "dp_total": 32, "experts_per_shard": 8}
    assert two["remat"] == "full" and two["bytes"] == dryrun.run_cell(
        "qwen3-moe-30b-a3b", "train_4k", True)["bytes"]
    assert factory.DECODE_SEQ_SHARD is False


def test_dry_run_cli_writes_one_record_a_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "both",
         "--out", str(tmp_path)], capture_output=True, text=True,
        timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == 2 * len(ARCHS) * len(SHAPES)
    recs = [json.loads(f.read_text()) for f in files]
    assert {(r["mesh"], r["arch"], r["shape"]) for r in recs} == set(
        itertools.product(FULL, ARCHS, SHAPES))
    assert all((r["status"] == "skipped") ==
               (r["shape"] == "long_500k" and
                not get_config(r["arch"]).sub_quadratic) for r in recs)
    assert "done, failures=0" in res.stdout
    assert dryrun.OUT_DIR == ROOT / "experiments" / "dryrun_torch"
    assert "/experiments/dryrun_torch/" in (ROOT / ".gitignore").read_text()
