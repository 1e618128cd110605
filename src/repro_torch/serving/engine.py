"""Bucketed serving over the ported estimators.

``NonNeuralServeEngine`` pads each request batch to a power-of-two bucket
(at most log2(max_batch) + 1 shapes per algorithm) and runs the
estimator's registry-dispatched batch path once per bucket; batches past
``max_batch`` are split.  ``KNNServeEngine`` is the kNN facade.

Counterpart of the JAX package's ``serving/engine.py``, single device.
``policy="int8"`` serves an engine-local ``quantized_copy`` of the
estimator (the caller's stays as it is) and fills ``quant_report``.  JAX
compiles one executable per bucket; here a bucket's first call loads the
CUDA kernels (built at first use), so warmup touches every bucket shape
before any timed call.  ``bucket_launches`` counts production launches
per bucket and never warmup.

Autotune (the paper's profile-then-optimize, §5.2, at warmup time):
``warmup(X, autotune=True)`` and ``warmup_buckets(d, autotune=True)``
time every registered arm of the estimator's hot op at each bucket
(``_measure``: the least host time of 3 launches after a warm one, each
between two synchronizes) and route the bucket's production launches
through the fastest (``tuned``, a ``TunedArm`` a bucket).  The JAX
package's candidates without its ``bn`` arms (a Pallas row-block size the
CUDA kernels do not have) and with the one strategy ``single`` until the
sharded layer exists; never ``quant``, and on a card never ``ref`` (the
plain version serves no production launch there, however it times); an
explicit ``path=``, ``REPRO_BACKEND`` or the int8 policy collapses the
path axis.

``sibling`` builds an engine over a cheaper representation of the same
fitted model, the brownout ladder's constructor (``serving/degrade.py``).

Multi-tenant serving (``serving/model_store.py``): ``classify_group``
serves a stacked model group's (G, B, d) queries in one launch a (group
bucket, query bucket) cell, G padded to a power of two by repeating the
last tenant, through the estimator's grouped arm
(``predict_batch_group_fn``: B1, B2 and B3 with a tenant axis);
``warmup_groups`` runs every cell a tenant stream can reach, and
``group_launches`` counts production launches a cell.

``ServeEngine`` is the LM engine (dense family): ``generate`` runs the
prompt through ``prefill`` (B10 for every projection and the unembedding,
B11 for causal attention), then one ``decode_step`` per new token (B10 at
M = batch; attention over the cache in torch ops), greedy or sampled.
"""
from __future__ import annotations

import copy as _copy
import itertools
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core import knn as _knn
from repro_torch.core.estimator import KNNEstimator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models import transformer


@dataclass
class ClassifyResult:
    classes: torch.Tensor      # (B,) int32 prediction per query
    aux: torch.Tensor          # (B, ...) algorithm evidence (see estimator)
    launches: int              # bucket launches used for this request
    algorithm: str = "knn"

    @property
    def neighbors(self) -> torch.Tensor:
        """kNN alias: aux is the (B, k) neighbour indices."""
        if self.algorithm != "knn":
            raise AttributeError(
                f"ClassifyResult.neighbors is kNN-only; this result came "
                f"from {self.algorithm!r}, whose aux is its own evidence")
        return self.aux


@dataclass
class GroupClassifyResult:
    """One grouped (multi-tenant) call: per-tenant rows of predictions and
    evidence, sliced back to the caller's (G, B) from the padded (group
    bucket, bucket) launch shape."""
    classes: torch.Tensor      # (G, B) int32 prediction per tenant x query
    aux: torch.Tensor          # (G, B, ...) per-tenant algorithm evidence
    launches: int              # grouped launches used
    algorithm: str = "knn"


# tells two engines apart for result-cache keys even when they wrap the
# same estimator: serving/scheduler.py folds the fingerprint into its keys,
# so the same query bytes against different engines or policies never
# cross-hit
_ENGINE_SEQ = itertools.count()


@dataclass
class TunedArm:
    """One bucket's autotune verdict: the measured-fastest registered arm
    next to what the static selector would have run.

    ``path=None`` means "the estimator's own" (registry default): the
    winner may be the static choice, and routing through it is then a
    no-op.  ``bn`` is always None here (the CUDA kernels have no row-block
    knob); it stays for the JAX package's field order."""

    strategy: str
    path: Optional[str]
    bn: Optional[int]
    us: float                 # winning measured us per launch
    static_strategy: str
    static_path: str
    static_us: float
    # every (strategy, path, bn, us) measured, for reports and tests
    candidates: List[Tuple] = field(default_factory=list)

    @property
    def differs(self) -> bool:
        """Did measurement overturn the static selector?"""
        return (self.strategy != self.static_strategy
                or (self.path is not None and self.path != self.static_path)
                or self.bn is not None)


class NonNeuralServeEngine:
    """Power-of-two bucket batching over a fitted estimator, on one device
    (the card unless ``device="cpu"`` is named, and the estimator's)."""

    def __init__(self, estimator, *, max_batch: int = 1024,
                 device: DeviceLike = None, policy: Optional[str] = None,
                 mesh=None, sharded: bool = False,
                 strategy: Optional[str] = None, max_group: int = 64):
        if mesh is not None or sharded or strategy not in (None, "single"):
            raise NotImplementedError(
                "sharded serving is not ported yet (ROADMAP A15)")
        if not estimator.fitted:
            raise ValueError("fit the estimator before serving it")
        self.device = resolve_device(device)
        if estimator.device != self.device:
            raise ValueError(f"estimator lives on {estimator.device}, the "
                             f"engine on {self.device}")
        self.quant_report: Optional[Dict[str, int]] = None
        if policy is not None and str(policy).split("@")[0] == "int8":
            # quantize into an engine-local copy: quantize() would rewrite
            # the caller's params under any other engine sharing them.  A
            # fit under the int8 policy arrives quantized and passes through
            from repro_torch.serving import quant as _q
            if estimator.quantized:
                fp32 = estimator.dequantize_params()
            else:
                fp32 = estimator.params
                estimator = estimator.quantized_copy()
            self.quant_report = {
                "bytes_int8": _q.param_bytes(estimator.params),
                "bytes_fp32": _q.param_bytes(fp32),
                "bytes_predicted": _q.quant_bytes(fp32, min_size=1),
            }
        self.estimator = estimator
        self.algorithm = estimator.algorithm
        self.max_batch = int(max_batch)
        self.bucket_launches: Dict[int, int] = {}
        self.warmed: set = set()     # bucket sizes already run once
        self._quantized = bool(estimator.quantized)
        self._cost_shape = estimator.serve_cost_shape()
        self.tuned: Dict[int, TunedArm] = {}   # bucket -> autotune verdict
        self._fn = estimator.predict_batch_fn()      # the default arm
        self._fns: Dict[str, object] = {}      # path -> its arm's fn
        self.cache_fingerprint = (self.algorithm, str(policy),
                                  next(_ENGINE_SEQ))
        # grouped (multi-tenant) state
        self.max_group = int(max_group)
        self.warmed_groups: Set[Tuple[int, int]] = set()   # (g, b) run once
        self.group_launches: Dict[Tuple[int, int], int] = {}
        self._gfn = None

    def sibling(self, *, policy: Optional[str] = None, estimator=None,
                max_batch: Optional[int] = None) -> "NonNeuralServeEngine":
        """An engine over a cheaper representation of the SAME fitted
        model, on this engine's device: ``policy="int8"`` serves the
        estimator's ``quantized_copy``; ``estimator=`` substitutes another
        arm (an ANN index over an exact kNN's reference set).  Siblings
        share this engine's bucket geometry unless ``max_batch`` widens it
        (a cheaper tier may take a larger per-drain budget)."""
        est = self.estimator if estimator is None else estimator
        return NonNeuralServeEngine(
            est, max_batch=int(max_batch or self.max_batch),
            device=self.device, policy=policy, max_group=self.max_group)

    def _bucket(self, b: int) -> int:
        size = 1
        while size < b:
            size *= 2
        return min(size, self.max_batch)

    def _route(self, bucket: int) -> str:
        """The partition strategy serving this bucket: one device."""
        return "single"

    def _fn_for(self, strategy: str, path: Optional[str] = None,
                bn: Optional[int] = None):
        """The executor of one (strategy, path, bn) arm.  ``path``
        overrides the estimator's through a shallow copy whose
        ``predict_batch_fn`` closes over it (cached per arm); None keeps
        the estimator's own, ``_fn``."""
        if strategy != "single" or bn is not None:
            raise NotImplementedError(
                f"arm {(strategy, path, bn)}: one device and no row-block "
                "knob (the sharded strategies are ROADMAP A15)")
        if path is None:
            return self._fn
        fn = self._fns.get(path)
        if fn is None:
            est = _copy.copy(self.estimator)
            est.path = path
            fn = self._fns[path] = est.predict_batch_fn()
        return fn

    def _choice(self, bucket: int) -> Tuple[str, Optional[str],
                                            Optional[int]]:
        """The (strategy, path, bn) arm serving this bucket: the autotuned
        winner where ``warmup(autotune=True)`` measured one, else the
        static route with the estimator's own path."""
        arm = self.tuned.get(bucket)
        if arm is not None:
            return arm.strategy, arm.path, arm.bn
        return self._route(bucket), None, None

    # overridable seam: tests script timings through it to flip decisions
    def _measure(self, fn, params, chunk, iters: int = 3) -> float:
        """Least host time (us) of one launch over ``iters`` launches
        after one warm launch, each between two synchronizes."""
        fn(params, chunk)
        self._sync()
        best = float("inf")
        for _ in range(iters):
            t0 = _time.perf_counter()
            fn(params, chunk)
            self._sync()
            best = min(best, _time.perf_counter() - t0)
        return best * 1e6

    def _static_arm(self, bucket: int) -> Tuple[str, str]:
        """(strategy, path) the static selectors would run at this
        bucket."""
        strategy = self._route(bucket)
        if self._quantized:
            return strategy, "quant"
        op = dispatch.HOT_OPS[self.algorithm]
        kw = dispatch.hot_shape_kw(self.algorithm, self._cost_shape, bucket)
        return strategy, dispatch.resolve(
            self.algorithm, op, path=self.estimator.path,
            policy=self.estimator.policy, device=self.device, **kw).name

    def _autotune_candidates(self, bucket: int):
        """Registered (strategy, path, bn) arms worth timing at this
        bucket: the static arm first, then every registered path of the
        hot op that measurement may route to on this engine's device
        (``dispatch.measured_arm_ok``: never ``quant``, and ``ref`` only
        on the CPU).  An explicit ``path=``, ``REPRO_BACKEND`` or
        the int8 policy collapses the path axis to the static arm; every
        candidate comes from the registry, so ``bucket_launches ⊆ warmed``
        holds for whatever wins."""
        algo, op = self.algorithm, dispatch.HOT_OPS[self.algorithm]
        paths: List[Optional[str]] = [None]
        if (self.estimator.path is None and not self._quantized
                and dispatch.env_override() is None):
            regd = dispatch.registered().get((algo, op), ())
            paths = [p for p in regd
                     if dispatch.measured_arm_ok(p, self.device)] or [None]
        arms = [(self._route(bucket), None, None)]   # the static arm
        for p in paths:
            if (self._route(bucket), p, None) not in arms:
                arms.append((self._route(bucket), p, None))
        return arms

    def _autotune_bucket(self, size: int, chunk) -> Optional[TunedArm]:
        """Time every candidate arm for one bucket, record the winner in
        ``self.tuned``, and route this bucket through it.  An arm that
        refuses the bucket's shapes (``dispatch.arm_fits``: fused kNN past
        B1's lists) is not timed."""
        static_strategy, static_path = self._static_arm(size)
        op = dispatch.HOT_OPS[self.algorithm]
        kw = dispatch.hot_shape_kw(self.algorithm, self._cost_shape, size)
        measured, static_us = [], None
        for s, p, bn in self._autotune_candidates(size):
            if p is not None and not dispatch.arm_fits(self.algorithm, op,
                                                       p, **kw):
                continue
            us = self._measure(self._fn_for(s, p, bn), self.estimator.params,
                               chunk)
            measured.append((s, p, bn, us))
            if (s == static_strategy and bn is None
                    and (p is None or p == static_path)):
                static_us = us if static_us is None else min(static_us, us)
        if not measured:
            return None
        s, p, bn, us = min(measured, key=lambda m: m[3])
        arm = TunedArm(strategy=s, path=p, bn=bn, us=us,
                       static_strategy=static_strategy,
                       static_path=static_path,
                       static_us=static_us if static_us is not None else us,
                       candidates=measured)
        self.tuned[size] = arm
        return arm

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _as_queries(self, X) -> torch.Tensor:
        """Queries on the engine's device; float64 becomes float32, as in
        ``Estimator._tensor``."""
        if isinstance(X, np.ndarray):
            X = torch.from_numpy(np.ascontiguousarray(X))
        dtype = torch.float32 if getattr(X, "dtype", None) == torch.float64 \
            else None
        return torch.as_tensor(X, dtype=dtype, device=self.device)

    def _empty(self) -> ClassifyResult:
        return ClassifyResult(
            classes=torch.zeros((0,), dtype=torch.int32, device=self.device),
            aux=self.estimator.empty_aux(), launches=0,
            algorithm=self.algorithm)

    def _warm_one(self, size: int, chunk: torch.Tensor,
                  autotune: bool = False) -> None:
        """Run one bucket shape once (with ``autotune``, every candidate
        arm through ``_measure``); never counted in ``bucket_launches``."""
        pad = size - chunk.shape[0]
        if pad:
            chunk = F.pad(chunk, (0, 0, 0, pad))
        chunk = chunk.contiguous()
        if autotune and self._autotune_bucket(size, chunk) is not None:
            self.warmed.add(size)
            return
        self._fn_for(*self._choice(size))(self.estimator.params, chunk)
        self._sync()
        self.warmed.add(size)

    def warmup(self, X, *, autotune: bool = False) -> int:
        """Run every bucket a ``classify(X)`` call would hit, including the
        smaller trailing-chunk bucket.  Returns the number of buckets.
        ``autotune=True`` times every candidate arm a bucket and routes
        the bucket's launches through the fastest (``tuned``)."""
        X = self._as_queries(X)
        sizes = {self._bucket(min(self.max_batch, X.shape[0] - lo))
                 for lo in range(0, X.shape[0], self.max_batch)}
        for size in sorted(sizes):
            self._warm_one(size, X[:size], autotune=autotune)
        return len(sizes)

    def warmup_buckets(self, d: int, *, dtype=torch.float32,
                       autotune: bool = False) -> int:
        """Run EVERY bucket ``classify`` can route a (B, d) batch to, so the
        kernel libraries are built and loaded before the first timed call.
        Returns the number of buckets.  ``autotune=True`` as in
        ``warmup``."""
        sizes, b = set(), 1
        while b < 2 * self.max_batch:
            sizes.add(self._bucket(b))
            b *= 2
        for size in sorted(sizes):
            self._warm_one(size, torch.zeros((size, d), dtype=dtype,
                                             device=self.device),
                           autotune=autotune)
        return len(sizes)

    def classify(self, X) -> ClassifyResult:
        """X: (B, d) queries -> per-query prediction + aux evidence.
        Asynchronous on the card: the result tensors are ready after a
        synchronize."""
        X = self._as_queries(X)
        B = X.shape[0]
        if B == 0:
            return self._empty()
        classes, auxes, launches = [], [], 0
        for lo in range(0, B, self.max_batch):
            chunk = X[lo: lo + self.max_batch]
            bucket = self._bucket(chunk.shape[0])
            pad = bucket - chunk.shape[0]
            if pad:
                chunk = F.pad(chunk, (0, 0, 0, pad))
            cls, aux = self._fn_for(*self._choice(bucket))(
                self.estimator.params, chunk.contiguous())
            classes.append(cls[: bucket - pad])
            auxes.append(aux[: bucket - pad])
            self.bucket_launches[bucket] = \
                self.bucket_launches.get(bucket, 0) + 1
            self.warmed.add(bucket)
            launches += 1
        return ClassifyResult(classes=torch.cat(classes),
                              aux=torch.cat(auxes), launches=launches,
                              algorithm=self.algorithm)

    # ------------------------------------------------ grouped (multi-tenant)

    def _group_bucket(self, g: int) -> int:
        """The power-of-two group bucket covering ``g`` tenants, so at most
        log2(max_group) x log2(max_batch) grouped cells exist."""
        size = 1
        while size < g:
            size *= 2
        return size

    def group_fn(self):
        """The grouped launch: the estimator's grouped arm
        (``predict_batch_group_fn``), built once."""
        if self._gfn is None:
            self._gfn = self.estimator.predict_batch_group_fn()
        return self._gfn

    @staticmethod
    def _group_resize(stacked, g: int):
        """Slice, or pad by repeating the last tenant, a stacked params
        NamedTuple to exactly ``g`` lanes; padding lanes compute throwaway
        predictions that are sliced off."""
        def one(leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            have = leaf.shape[0]
            if have == g:
                return leaf
            if have > g:
                return leaf[:g]
            return torch.cat([leaf, leaf[-1:].expand(
                (g - have,) + tuple(leaf.shape[1:]))])

        return type(stacked)(*(one(v) for v in stacked))

    def classify_group(self, stacked_params, Xg) -> GroupClassifyResult:
        """One multi-tenant call: stacked params (G, ...) and queries
        (G, B, d) -> per-tenant (G, B) predictions, each lane equal to
        ``classify`` with that tenant's params.  G pads to its power-of-two
        group bucket (repeating the last tenant), B to its query bucket;
        B past ``max_batch`` splits along the queries and G past the
        ``max_group`` bucket along the tenants, one launch a piece.
        Asynchronous on the card: the result is ready after a
        synchronize."""
        Xg = self._as_queries(Xg)
        if Xg.ndim != 3:
            raise ValueError(f"Xg must be (G, B, d), got {tuple(Xg.shape)}")
        G, B = Xg.shape[0], Xg.shape[1]
        top = self._group_bucket(self.max_group)
        if G > top:
            parts = [self.classify_group(
                _slice_lanes(stacked_params, lo, lo + top), Xg[lo: lo + top])
                for lo in range(0, G, top)]
            return GroupClassifyResult(
                classes=torch.cat([r.classes for r in parts]),
                aux=torch.cat([r.aux for r in parts]),
                launches=sum(r.launches for r in parts),
                algorithm=self.algorithm)
        gb = self._group_bucket(G)
        if gb > G:
            Xg = torch.cat([Xg, Xg.new_zeros((gb - G,) + Xg.shape[1:])])
        stacked = self._group_resize(stacked_params, gb)
        fn = self.group_fn()
        classes, auxes, launches = [], [], 0
        for lo in range(0, B, self.max_batch):
            chunk = Xg[:, lo: lo + self.max_batch]
            bucket = self._bucket(chunk.shape[1])
            pad = bucket - chunk.shape[1]
            if pad:
                chunk = F.pad(chunk, (0, 0, 0, pad))
            cls, aux = fn(stacked, chunk.contiguous())
            if pad:
                cls, aux = cls[:, : bucket - pad], aux[:, : bucket - pad]
            classes.append(cls)
            auxes.append(aux)
            self.group_launches[(gb, bucket)] = \
                self.group_launches.get((gb, bucket), 0) + 1
            self.warmed_groups.add((gb, bucket))
            launches += 1
        cls = classes[0] if launches == 1 else torch.cat(classes, dim=1)
        aux = auxes[0] if launches == 1 else torch.cat(auxes, dim=1)
        if gb > G:
            cls, aux = cls[:G], aux[:G]
        return GroupClassifyResult(classes=cls, aux=aux, launches=launches,
                                   algorithm=self.algorithm)

    def warmup_groups(self, stacked_params, d: int, *, g_sizes=None,
                      b_sizes=None, dtype=torch.float32) -> int:
        """Run every (group bucket, bucket) cell a tenant stream can route
        to, the grouped counterpart of ``warmup_buckets`` (the scheduler
        coalesces only into ``warmed_groups``).  ``g_sizes``/``b_sizes``
        restrict the lattice.  Warmup never lands in ``group_launches``.
        Returns the number of cells."""
        fn = self.group_fn()
        if g_sizes is None:
            gs, g = set(), 1
            top = self._group_bucket(self.max_group)
            while g <= top:
                gs.add(g)
                g *= 2
        else:
            gs = {self._group_bucket(g) for g in g_sizes}
        if b_sizes is None:
            bs, b = set(), 1
            while b < 2 * self.max_batch:
                bs.add(self._bucket(b))
                b *= 2
        else:
            bs = {self._bucket(b) for b in b_sizes}
        n = 0
        for g in sorted(gs):
            stacked = self._group_resize(stacked_params, g)
            for b in sorted(bs):
                fn(stacked, torch.zeros((g, b, d), dtype=dtype,
                                        device=self.device))
                self._sync()
                self.warmed_groups.add((g, b))
                n += 1
        return n


def _slice_lanes(stacked, lo: int, hi: int):
    """Lanes [lo, hi) of a stacked params NamedTuple."""
    return type(stacked)(*(v[lo:hi] if isinstance(v, torch.Tensor) else v
                           for v in stacked))


class KNNServeEngine(NonNeuralServeEngine):
    """Batched kNN classification from a ``KNNModel``."""

    def __init__(self, model: _knn.KNNModel, k: int, *,
                 max_batch: int = 1024, device: DeviceLike = None):
        if not 1 <= k <= model.A.shape[0]:
            raise ValueError(f"k={k} outside [1, {model.A.shape[0]}]")
        self.model = model
        self.k = int(k)
        super().__init__(KNNEstimator.from_params(model, k=k, device=device),
                         max_batch=max_batch, device=device)


@dataclass
class GenerationResult:
    tokens: torch.Tensor       # (B, n_new) int64
    logprobs: torch.Tensor     # (B, n_new) fp32 log-probability of each
    steps: int


class ServeEngine:
    """Greedy or sampled generation from a dense decoder's params (a tree
    from ``models.transformer.init_params`` or
    ``convert.lm_params_from_numpy``), on the params' device.

    ``path="ref"`` (or ``REPRO_BACKEND=ref``) runs B10 and B11's plain
    versions: the yardstick the kernels are held against on the card."""

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig = None,
                 *, path: Optional[str] = None):
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.serve_cfg = serve_cfg or ServeConfig()
        self.path = path
        self.device = params["embed"]["tok"].device

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, np.ndarray):
            tokens = torch.from_numpy(np.ascontiguousarray(tokens))
        return torch.as_tensor(tokens, device=self.device).to(torch.long)

    def prefill(self, tokens):
        """tokens: (B, S) -> (last logits (B, vocab), DecodeCache)."""
        return transformer.prefill(self.params, self._tokens(tokens),
                                   self.cfg, max_seq=self.serve_cfg.max_seq,
                                   path=self.path)

    def decode(self, cache, tokens):
        """tokens: (B, 1) -> (logits (B, vocab), the cache one on; written
        in place)."""
        return transformer.decode_step(self.params, cache,
                                       self._tokens(tokens), self.cfg,
                                       path=self.path)

    def generate(self, prompt_tokens, n_new: int, *,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None
                 ) -> GenerationResult:
        """Prefill the prompts (B, S), then ``n_new`` decode steps.
        ``temperature > 0`` samples from softmax(logits / temperature)
        with ``generator`` (a ``torch.Generator`` on the engine's device,
        so a seed gives the same tokens again); 0 is greedy.  Asynchronous
        on the card: the result is ready after a synchronize."""
        if temperature > 0.0 and generator is None:
            # checked before prefill, as the reference does
            raise ValueError(
                "generate(temperature>0) samples and needs generator= (a "
                "torch.Generator on the engine's device, for reproducible "
                "draws); greedy decoding (temperature=0.0) needs none")
        tokens = self._tokens(prompt_tokens)
        B, S = tokens.shape
        if S + n_new > self.serve_cfg.max_seq:
            raise ValueError(f"{S} prompt + {n_new} new tokens exceed "
                             f"max_seq={self.serve_cfg.max_seq}")
        logits, cache = self.prefill(tokens)
        toks, lps = [], []
        for _ in range(n_new):
            lf = logits.to(torch.float32)
            if temperature > 0.0:
                nxt = torch.multinomial(torch.softmax(lf / temperature, -1),
                                        1, generator=generator)[:, 0]
            else:
                nxt = torch.argmax(lf, dim=-1)
            toks.append(nxt)
            lps.append(torch.log_softmax(lf, -1).gather(1, nxt[:, None])[:, 0])
            logits, cache = self.decode(cache, nxt[:, None])
        return GenerationResult(tokens=torch.stack(toks, dim=1),
                                logprobs=torch.stack(lps, dim=1),
                                steps=n_new)
