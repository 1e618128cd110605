"""Whether a kernel's one-tenant launch is unchanged by a tenant axis: the
device time of B1, B2 and B3 at their main-path shapes for one checkout of
the port, and, given a second checkout, the SASS of every one-tenant
kernel of the two builds side by side.

    python3 src/repro_torch/launch/tenant_axis_check.py --src DIR \
        [--sass OTHER_DIR] [--reads 5]

Imports ``repro_torch`` from DIR (default: the ``src`` directory this file
lies in), builds its kernels, and times through the public wrappers:

  B1   ``ops.distance_topk``: 2^20 rows of seeded 3-class ``class_blobs``
       (d = 21, seed 0) against 1024 queries, k = 4 (the kNN path);
  B2   ``ops.distance_argmin``: 262,144 rows of 256-class blobs (d = 21,
       seed 1) against their first 256 (a K-Means fit step);
  B3   ``ops.gnb_scores_batch``: 1024 queries of 10-class blobs (d = 784,
       seed 2) against moments fitted on 60,000 rows (the GNB bucket);

each ``--reads`` times by ``lm_kernel_times.device_ms`` (a CUDA graph of
the calls replayed, timed by CUDA events).  Run it on a parent and on a
change in turns (p c c p), in one command on one card, to compare them.

With ``--sass OTHER_DIR`` (a checkout built already, by an earlier run of
this script on it) it disassembles the libraries of ``distance_topk.cu``,
``distance_argmin.cu`` and ``gnb_score.cu`` of both builds with
``cuobjdump -sass``, names each kernel with ``cu++filt``, drops a trailing
``false`` template argument (the tenant flag of a one-tenant
instantiation), pairs the kernels by that name and prints, for each pair,
both instruction counts and how many instructions differ (a grouped
instantiation, or a kernel one build lacks, is reported as "only in").
One JSON line per report; the card's name and power limit are in each.
"""
from __future__ import annotations

import argparse
import glob
import json
import re
import subprocess
import sys
from pathlib import Path

STEMS = ("distance_topk", "distance_argmin", "gnb_score")
CUDA_BIN = Path("/usr/local/cuda/bin")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def kernels(so: str):
    """{one-tenant name: [instructions]} of a built library."""
    sass = subprocess.run([str(CUDA_BIN / "cuobjdump"), "-sass", so],
                          capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        mangled = part.split("\n", 1)[0].strip()
        name = subprocess.run([str(CUDA_BIN / "cu++filt"), mangled],
                              capture_output=True, text=True,
                              check=True).stdout.strip()
        name = re.sub(r"^void ", "", name)
        name = re.sub(r"_GLOBAL__N__\w+", "", name)
        # a one-tenant instantiation's trailing ``false`` goes, so that it
        # pairs with the kernel of a checkout without the tenant axis; a
        # grouped one keeps its ``true`` and pairs with nothing
        # (cu++filt spells a bool argument "(bool)0" or "(bool)1")
        name = re.sub(r", ?(?:false|\(bool\)0)>", ">", name)
        name = re.sub(r"<(?:false|\(bool\)0)>", "", name)
        out[name] = [re.sub(r"\s+", " ", m.group(1)) for m in
                     re.finditer(r"/\*[0-9a-f]{4}\*/\s+(.*?);", part)]
    return out


def compare(src: Path, other: Path) -> dict:
    rows = {}
    for stem in STEMS:
        (mine,) = glob.glob(
            str(src / f"repro_torch/kernels/build/{stem}-*.so"))
        (theirs,) = glob.glob(
            str(other / f"repro_torch/kernels/build/{stem}-*.so"))
        a, b = kernels(theirs), kernels(mine)
        for name in sorted(set(a) | set(b)):
            x, y = a.get(name), b.get(name)
            if x is None or y is None:
                rows[name] = "only in " + ("this" if x is None else "other")
                continue
            rows[name] = dict(other=len(x), this=len(y), differ=sum(
                p != q for p, q in zip(x, y)) + abs(len(x) - len(y)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout's src directory")
    ap.add_argument("--sass", default=None, metavar="OTHER_DIR",
                    help="another checkout's src directory, built already")
    ap.add_argument("--reads", type=int, default=5)
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    from lm_kernel_times import device_ms
    from repro_torch.core.gnb import fit_gnb
    from repro_torch.data.datasets import class_blobs
    from repro_torch.kernels import _build, ops

    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    _build.build_all()
    dev = torch.device("cuda", 0)

    def on_card(a):
        return torch.from_numpy(a).to(dev)

    X, _ = class_blobs(n=(1 << 20) + 1024, d=21, n_class=3, seed=0)
    A, Q = on_card(X[: 1 << 20]), on_card(X[1 << 20:])
    X, _ = class_blobs(n=262144, d=21, n_class=256, seed=1)
    R = on_card(X)
    Cn = R[:256].clone()
    X, y = class_blobs(n=60000 + 1024, d=784, n_class=10, seed=2)
    g = fit_gnb(on_card(X[:60000]), on_card(y[:60000]), 10)
    Xq = on_card(X[60000:])
    cases = {
        "b1_knn": lambda: ops.distance_topk(A, Q, 4),
        "b2_fit": lambda: ops.distance_argmin(R, Cn),
        "b3_bucket": lambda: ops.gnb_scores_batch(Xq, g.mu, g.var,
                                                  g.log_prior)}
    times = {k: [device_ms(fn, 20) for _ in range(args.reads)]
             for k, fn in cases.items()}
    print(json.dumps({"src": str(src), "card": card(),
                      "torch": torch.__version__, "device_ms": times}))
    if args.sass:
        print(json.dumps({"src": str(src), "other": args.sass,
                          "card": card(),
                          "sass": compare(src, Path(args.sass).resolve())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
