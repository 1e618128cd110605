"""Device times of B10 (``ops.matmul``) and B11 (``ops.flash_attention``)
at the shapes of the LM serving path, and the path's own prefill and
``generate`` times, for one checkout of the port.

    python3 src/repro_torch/launch/lm_kernel_times.py [--src DIR]

Imports ``repro_torch`` from DIR (default: the ``src`` directory this
file lies in), builds its kernels, and times the wrappers at every
projection shape of stablelm-3b served at batch 4 with prompts of 512
(prefill M = 2048, decode M = 4, the unembedding at M = 4) and at the
prefill attention shape (4, 32, 512, 80), causal, in the models' (B, S,
H, d) layout, with ``torch.matmul`` and SDPA beside them as yardsticks.
Only the public wrappers are called, so the same script times an older
checkout: run it on two checkouts in one command on one card (parent,
change, change, parent) to compare their kernels.  A kernel time is the
replay of 20 calls captured as a CUDA graph, timed by CUDA events, per
call: device time, without the host's time to issue the call.  The path
is stablelm-3b at full width with seeded weights, batch 4, prompts of
512 tokens, 32 greedy new tokens, through the public ``ServeEngine``:
host-clock prefill and ``generate`` times (three readings each, after a
warm call), before and after the kernels are timed.  Prints one JSON
line; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPS = 20


def device_ms(fn, reps: int = REPS) -> float:
    """Mean device time of one call of ``fn``: ``reps`` calls captured
    once as a CUDA graph (after warm calls on a side stream, as capture
    asks), then the graph's replay timed by CUDA events, so the kernels
    run back to back and the host's time to issue each call is left out.
    Kept here, not in the package, so that it times an older checkout as
    well."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def device_kernels(window) -> dict:
    """The device time of the kernels ``window()`` runs, in ms by kernel
    name, largest first (``torch.profiler``'s ``key_averages``).  A
    process that has run the profiler issues later launches more slowly,
    so host-clock times come before the first such window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    ms = {e.key: getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)) / 1e3
          for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    return dict(sorted(((k, v) for k, v in ms.items() if v > 0),
                       key=lambda kv: -kv[1]))


def serve_times(torch, engine, prompts, new: int):
    """Host-clock ms of three prefills and s of three ``generate`` calls,
    each ending in a synchronize."""
    pre, gen = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.prefill(prompts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.generate(prompts, new)
        torch.cuda.synchronize()
        pre.append((t1 - t0) * 1e3)
        gen.append(time.perf_counter() - t1)
    return dict(prefill_ms=pre, generate_s=gen)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src directory of the checkout to time")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.models import transformer
    from repro_torch.serving import ServeEngine

    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    cfg = get_config("stablelm-3b")
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    Bt, P = 4, 512
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    new = 32
    params = transformer.init_params(cfg, gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (Bt, P), generator=gen,
                            device=dev)
    engine = ServeEngine(cfg, params, ServeConfig(max_seq=P + new))
    engine.generate(prompts[:, :16], 2)          # first calls
    serve = serve_times(torch, engine, prompts, new)
    shapes = {"prefill qkvo": (Bt * P, d, d),
              "prefill in/gate": (Bt * P, ff, d),
              "prefill out": (Bt * P, d, ff), "decode qkvo": (Bt, d, d),
              "decode in/gate": (Bt, ff, d), "decode out": (Bt, d, ff),
              "unembed": (Bt, V, d)}
    b10 = {}
    for key, (M, N, K) in shapes.items():
        a = torch.randn((M, K), generator=gen, device=dev).to(bf)
        w = torch.randn((K, N), generator=gen, device=dev).to(bf)
        out = ops.matmul(a, w)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"B10 {key}: output not finite")
        b10[key] = dict(M=M, N=N, K=K,
                        dev_ms=device_ms(lambda: ops.matmul(a, w)),
                        lib_dev_ms=device_ms(lambda: torch.matmul(a, w)))
    x = torch.randn((Bt, P, 3, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=dev).to(bf)
    q, k, v = (x[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    b11 = dict(dev_ms=device_ms(lambda: ops.flash_attention(q, k, v)),
               lib_dev_ms=device_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       qc, kc, vc, is_causal=True)))
    serve_after = serve_times(torch, engine, prompts, new)
    print(json.dumps(dict(src=str(Path(args.src).resolve()), card=card,
                          torch=torch.__version__, reps=REPS, b10=b10,
                          b11=b11, serve=serve, serve_after=serve_after)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
