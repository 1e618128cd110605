"""B10 and B11 under autograd: the forms the training path calls.

The wrappers of ``kernels/ops.py`` launch their kernels through ctypes, so
their outputs carry no autograd graph.  This module registers two PyTorch
operators whose forward is the wrapper and whose backward is a kernel too:

  * ``matmul(a, b)`` (B10): forward ``ops.matmul(a, b)``; backward
    ``dA = ops.matmul(dC, b^T)`` and ``dB = ops.matmul(a^T, dC)``, each on
    contiguous transposed copies (B10 takes contiguous operands), each
    computed only where its input needs a gradient;
  * ``flash_attention(q, k, v, causal)`` (B11): forward
    ``ops.flash_attention``; backward B12, ``ops.flash_attention_bwd``,
    from q, k, v, the forward's output and the output's gradient.

The JAX package has no counterpart: its LM products are jnp ops that XLA
differentiates.  Both are ``torch.library.custom_op`` operators with
``register_autograd`` rather than ``torch.autograd.Function`` classes, so
that a dispatch mode sees each as one operator: selective activation
checkpointing (``models/transformer.py``, remat ``dots``) saves B10's
outputs by naming ``MATMUL_OP``, as the reference's
``checkpoint_dots_with_no_batch_dims`` saves its dots, and recomputes
the rest.  On CPU tensors the wrappers run their plain versions, so the
same operators serve the CPU tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


@torch.library.custom_op("repro_torch::matmul", mutates_args=())
def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B10 with a gradient: a (M, K) @ b (K, N) -> (M, N), both
    contiguous, one dtype."""
    return ops.matmul(a, b)


@matmul.register_fake
def _matmul_fake(a, b):
    return a.new_empty((a.shape[0], b.shape[1]))


def _matmul_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _matmul_backward(ctx, grad):
    a, b = ctx.saved_tensors
    g = grad.contiguous()
    da = ops.matmul(g, b.t().contiguous()) if ctx.needs_input_grad[0] \
        else None
    db = ops.matmul(a.t().contiguous(), g) if ctx.needs_input_grad[1] \
        else None
    return da, db


matmul.register_autograd(_matmul_backward, setup_context=_matmul_setup)

MATMUL_OP = torch.ops.repro_torch.matmul.default


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    """B11 with a gradient (B12): q, k, v (B, H, S, d) -> (B, H, S, d) in
    q's dtype and layout."""
    return ops.flash_attention(q, k, v, causal=causal)


@flash_attention.register_fake
def _flash_attention_fake(q, k, v, causal):
    return torch.empty_like(q)


def _attention_setup(ctx, inputs, output):
    q, k, v, causal = inputs
    ctx.save_for_backward(q, k, v, output)
    ctx.causal = causal


def _attention_backward(ctx, grad):
    q, k, v, o = ctx.saved_tensors
    if grad.stride(-1) != 1:
        grad = grad.contiguous()
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, o, grad, causal=ctx.causal)
    return dq, dk, dv, None


flash_attention.register_autograd(_attention_backward,
                                  setup_context=_attention_setup)

ATTENTION_OP = torch.ops.repro_torch.flash_attention.default


def records(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an operation on these inputs: grad mode is
    on and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
