"""W8A8 dynamic-int8 serving quantization.

Counterpart of ``arkflow_tpu/models/quantize.py`` (``quantize_dense``,
``quantize_for_serving``, ``dense_w8a8``) on the same tree layout:

- Weights: symmetric per-output-channel int8 at load time
  (``scale = absmax over the in dim / 127``), stored as
  ``{"w_q": int8 [..., in, out], "w_scale": f32 [..., 1, out], "b": bf16}``,
  ``w_q`` laid out column-major (``quantize_dense``).
  The leading stack axis of scan-stacked layer params rides along in both.
  Every other floating leaf (embeddings, norms) becomes bf16.
- Activations: symmetric per-row dynamic int8 at every call (absmax over
  the feature dim).
- Product: int8 x int8 -> int32 (``int8_matmul``), dequantized by
  ``row_scale * col_scale`` and biased in the compute dtype.

``common.dense`` dispatches on the presence of ``w_q``, so every family whose
dense layers go through it serves int8 without model code. Attention stays in
the model's float path. Both packages round half to even and divide in the
weight's (or f32 activations') dtype, so ``w_q`` and the activations' int8
codes come out bit for bit as JAX's.

On an NVIDIA H100 SXM at its 700 W limit the datasheet gives 1979 dense
int8 TOPS on the tensor cores against 989 bf16 TFLOP/s, and an int8 weight
moves half a bf16 one's bytes. What that buys end to end is measured by
``chip_smoke.py`` (the int8 phases; PERF.md). ``quantize_param_specs`` waits
for the multi-GPU slice.
"""

from __future__ import annotations

import torch

from arkflow_tpu_torch.ops.ragged_attention import LaunchCounter

#: dense-param dicts are {"w": [in, out] (or [..., in, out] stacked), "b"?}
_WEIGHT_KEY = "w"
#: ``torch._int_mm``'s limits on CUDA: more than 16 rows, and inner and
#: column sizes that are multiples of 8. Zero rows and columns pad a product
#: onto them, which is exact in integers.
_MIN_ROWS = 17
_MULTIPLE = 8

#: int8 products computed (on any device), as the kernels count launches
int8_products = LaunchCounter()


def quantize_dense(p: dict) -> dict:
    """One dense-param dict -> its W8A8 serving form (bias kept, bf16)."""
    w = p[_WEIGHT_KEY]
    scale = torch.clamp_min(w.abs().amax(dim=-2, keepdim=True) / 127.0, 1e-8)
    w_q = torch.round(w / scale).to(torch.int8)
    # column-major: the shape and values stay the JAX tree's [..., in, out],
    # each output channel's in-dim lies contiguous in memory, and the
    # transfer to the device keeps the strides. torch._int_mm on the H100
    # takes such a weight ~4x faster than a row-major one (chip_smoke.py,
    # "int8 product"). A row-major w_q (a JAX tree carried across) serves too.
    out = {"w_q": w_q.transpose(-1, -2).contiguous().transpose(-1, -2),
           "w_scale": scale.float()}
    if "b" in p:
        out["b"] = p["b"].to(torch.bfloat16)
    return out


def quantize_for_serving(params) -> tuple[dict, int]:
    """Walk a param tree: int8-quantize every dense dict (a floating ``w`` of
    two or more dims), cast the remaining floating leaves to bf16. Returns
    (new_params, quantized_dense_count)."""
    count = 0

    def walk(node):
        nonlocal count
        if isinstance(node, dict):
            w = node.get(_WEIGHT_KEY)
            if isinstance(w, torch.Tensor) and w.is_floating_point() and w.dim() >= 2:
                count += 1
                return quantize_dense(node)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor) and node.is_floating_point():
            return node.to(torch.bfloat16)
        return node

    return walk(params), count


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """[..., K] int8 x [K, N] int8 -> [..., N] int32, exact. The rows are
    flattened and the operands padded with zeros onto ``torch._int_mm``'s
    limits (the classifier's N = 2, a pooler over a few rows); the padding
    is sliced off the result."""
    lead = x_q.shape[:-1]
    k, n = w_q.shape
    a = x_q.reshape(-1, k)
    m = a.shape[0]
    pad_m, pad_k, pad_n = max(_MIN_ROWS - m, 0), -k % _MULTIPLE, -n % _MULTIPLE
    if pad_m or pad_k:
        a = torch.nn.functional.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        w_q = torch.nn.functional.pad(w_q, (0, pad_n, 0, pad_k))
    acc = torch._int_mm(a, w_q)
    int8_products.add()
    return acc[:m, :n].reshape(*lead, n)


def dense_w8a8(p: dict, x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 dynamic-activation dense: quantize the rows of ``x``, int8
    product with an int32 accumulator, dequantize, bias."""
    xf = x.float()
    row_scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-6) / 127.0
    x_q = torch.round(xf / row_scale).to(torch.int8)
    acc = int8_matmul(x_q, p["w_q"])
    # w_scale is [..., 1, out]; drop its kept in-dim axis to broadcast [out]
    y = (acc.float() * row_scale * p["w_scale"].squeeze(-2)).to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y
