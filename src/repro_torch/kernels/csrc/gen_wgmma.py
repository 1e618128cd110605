#!/usr/bin/env python3
"""Write ``wgmma.cuh``: one inline-PTX wrapper per ``wgmma.mma_async``
shape that B10 (``gemm.cu``) and B11 (``flash_attention.cu``) issue.

    python3 src/repro_torch/kernels/csrc/gen_wgmma.py

A ``wgmma`` instruction names every accumulator register of its thread
(N/2 of them for m64nNk16), so each N needs its own asm string; this
script writes them out rather than 1,000 lines by hand.  The header is
committed; ``tests/test_torch_lm_kernels.py`` checks that it matches this
script's output.

  WgmmaSS<N>::run<TA, TB>(d, desc_a, desc_b, scale_d)
      d (64 x N fp32, N/2 registers a thread) += A (64 x 16, shared
      memory) · B (16 x N, shared memory); TA/TB = 1: that operand is
      MN-major (the transpose bits), 0: K-major.
  WgmmaRS<N>::run<TB>(d, a0, a1, a2, a3, desc_b, scale_d)
      the same with A in registers: four 32-bit words of bf16 pairs, in
      the accumulator's row layout (the A fragment of mma.sync m16n8k16).
scale_d = 0 drops the old d (d = A·B).
"""
from pathlib import Path

SS_N = (64, 192)
RS_N = tuple(range(16, 129, 16))
OUT = Path(__file__).resolve().with_name("wgmma.cuh")


def _regs(n_regs: int) -> str:
    return ", ".join(f"%{i}" for i in range(n_regs))


def _outs(n_regs: int) -> str:
    return ", ".join(f'"+f"(d[{i}])' for i in range(n_regs))


def _ss(n: int) -> str:
    r = n // 2
    return f"""template <> struct WgmmaSS<{n}> {{
    template <int TA, int TB>
    static __device__ __forceinline__ void run(float (&d)[{r}], uint64_t a,
                                               uint64_t b, int scale_d) {{
        asm volatile(
            "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
            "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
            "{{{_regs(r)}}}, %{r}, %{r + 1}, p, 1, 1, %{r + 3}, %{r + 4};\\n}}\\n"
            : {_outs(r)}
            : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
    }}
}};
"""


def _rs(n: int) -> str:
    r = n // 2
    return f"""template <> struct WgmmaRS<{n}> {{
    template <int TB>
    static __device__ __forceinline__ void run(float (&d)[{r}], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint64_t b,
                                               int scale_d) {{
        asm volatile(
            "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
            "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
            "{{{_regs(r)}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, "
            "p, 1, 1, %{r + 6};\\n}}\\n"
            : {_outs(r)}
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d),
              "n"(TB));
    }}
}};
"""


def render() -> str:
    head = (
        "// Generated by gen_wgmma.py in this directory; do not edit.\n"
        "// wgmma.mma_async wrappers, m64nNk16, bf16 x bf16 -> fp32, for\n"
        f"// N in {SS_N} (both operands in shared memory)\n"
        f"// and N in {RS_N} (A in registers).\n"
        "#pragma once\n#include <cstdint>\n\n"
        "template <int N> struct WgmmaSS;\n"
        "template <int N> struct WgmmaRS;\n\n")
    return head + "\n".join([_ss(n) for n in SS_N] + [_rs(n) for n in RS_N])


if __name__ == "__main__":
    OUT.write_text(render())
    print(f"wrote {OUT}")
