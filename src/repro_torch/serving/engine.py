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

``ServeEngine`` is the LM engine (dense family): ``generate`` runs the
prompt through ``prefill`` (B10 for every projection and the unembedding,
B11 for causal attention), then one ``decode_step`` per new token (B10 at
M = batch; attention over the cache in torch ops), greedy or sampled.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core import knn as _knn
from repro_torch.core.estimator import KNNEstimator
from repro_torch.device import DeviceLike, resolve_device
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


class NonNeuralServeEngine:
    """Power-of-two bucket batching over a fitted estimator, on one device
    (the card unless ``device="cpu"`` is named, and the estimator's)."""

    def __init__(self, estimator, *, max_batch: int = 1024,
                 device: DeviceLike = None, policy: Optional[str] = None,
                 mesh=None, sharded: bool = False,
                 strategy: Optional[str] = None):
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
        self._fn = estimator.predict_batch_fn()

    def _bucket(self, b: int) -> int:
        size = 1
        while size < b:
            size *= 2
        return min(size, self.max_batch)

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

    def _warm_one(self, size: int, chunk: torch.Tensor) -> None:
        """Run one bucket shape once; never counted in ``bucket_launches``."""
        pad = size - chunk.shape[0]
        if pad:
            chunk = F.pad(chunk, (0, 0, 0, pad))
        self._fn(self.estimator.params, chunk.contiguous())
        self._sync()
        self.warmed.add(size)

    def warmup(self, X, *, autotune: bool = False) -> int:
        """Run every bucket a ``classify(X)`` call would hit, including the
        smaller trailing-chunk bucket.  Returns the number of buckets."""
        if autotune:
            raise NotImplementedError(
                "autotuned warmup is not ported yet (ROADMAP A14)")
        X = self._as_queries(X)
        sizes = {self._bucket(min(self.max_batch, X.shape[0] - lo))
                 for lo in range(0, X.shape[0], self.max_batch)}
        for size in sorted(sizes):
            self._warm_one(size, X[:size])
        return len(sizes)

    def warmup_buckets(self, d: int, *, dtype=torch.float32,
                       autotune: bool = False) -> int:
        """Run EVERY bucket ``classify`` can route a (B, d) batch to, so the
        kernel libraries are built and loaded before the first timed call.
        Returns the number of buckets."""
        if autotune:
            raise NotImplementedError(
                "autotuned warmup is not ported yet (ROADMAP A14)")
        sizes, b = set(), 1
        while b < 2 * self.max_batch:
            sizes.add(self._bucket(b))
            b *= 2
        for size in sorted(sizes):
            self._warm_one(size, torch.zeros((size, d), dtype=dtype,
                                             device=self.device))
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
            cls, aux = self._fn(self.estimator.params, chunk.contiguous())
            classes.append(cls[: bucket - pad])
            auxes.append(aux[: bucket - pad])
            self.bucket_launches[bucket] = \
                self.bucket_launches.get(bucket, 0) + 1
            self.warmed.add(bucket)
            launches += 1
        return ClassifyResult(classes=torch.cat(classes),
                              aux=torch.cat(auxes), launches=launches,
                              algorithm=self.algorithm)


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
