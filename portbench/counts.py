"""The benchmark's yardstick: operations and bytes of the denoiser's layers,
worked out from shapes alone, and the card's published peaks.

The counts are of the layer's mathematics, whatever implements it: a kernel
that recomputes, stores or fuses counts the same. Inference: one post-LN
encoder layer (packed qkv projection, S x S attention over all heads, output
projection, two FFN GEMMs). Training: the forward plus a backward of twice
its operations, with no recompute, so the store path and the recompute path
of the training kernels are held to one count.
"""
from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense rates, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def layer_flops(b: int, s: int, d: int, f: int) -> float:
    """Operations of one encoder layer's forward over b rows of s tokens:
    qkv, q k^T and p v, the output projection and the two FFN GEMMs."""
    m = b * s
    return 2 * m * d * 3 * d + 2 * 2 * b * s * s * d + 2 * m * d * d + 2 * 2 * m * d * f


def layer_weight_elems(d: int, f: int) -> tuple:
    """(matrix elements, vector elements) of one layer's parameters."""
    return 3 * d * d + d * d + 2 * d * f, 3 * d + d + 4 * d + f + d


def layer_bytes(b: int, s: int, d: int, f: int) -> float:
    """Bytes of one inference layer: its bf16 activations read once and
    written once, its bf16 weight matrices and fp32 vectors read once."""
    mats, vecs = layer_weight_elems(d, f)
    return 2 * b * s * d * 2 + mats * 2 + vecs * 4


def train_layer_flops(b: int, s: int, d: int, f: int) -> float:
    """Forward plus a backward of twice the forward's operations."""
    return 3 * layer_flops(b, s, d, f)


def train_layer_bytes(b: int, s: int, d: int, f: int) -> float:
    """Forward: input read, output written, weights read. Backward: the
    output's gradient and the input read, the input's gradient written, the
    weights read and their fp32 gradients written. bf16 activations."""
    mats, vecs = layer_weight_elems(d, f)
    act = b * s * d * 2
    weights = mats * 2 + vecs * 4
    return (2 * act + weights) + (3 * act + weights + (mats + vecs) * 4)


def bound_seconds(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple:
    """(least seconds, 'operations' | 'bytes') on one card."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def layer_bound(b: int, s: int, d: int, f: int) -> tuple:
    """(least seconds, bound_by, flops, bytes) of one inference layer."""
    flops, nbytes = layer_flops(b, s, d, f), layer_bytes(b, s, d, f)
    return bound_seconds(flops, nbytes) + (flops, nbytes)


def train_layer_bound(b: int, s: int, d: int, f: int) -> tuple:
    """(least seconds, bound_by, flops, bytes) of one layer's training
    forward and backward."""
    flops, nbytes = train_layer_flops(b, s, d, f), train_layer_bytes(b, s, d, f)
    return bound_seconds(flops, nbytes) + (flops, nbytes)


def denoiser_flops(rows: int, frames: int, cfg: dict) -> float:
    """Operations of one MDM trans_enc forward over `rows` clips of `frames`
    frames: the frame embedding, the timestep MLP, the text projection, the
    encoder layers over frames + 1 tokens and the output head."""
    d, f, c = cfg["latent_dim"], cfg["ff_size"], cfg["njoints"] * cfg["nfeats"]
    embed = 2 * rows * frames * c * d + 2 * rows * 2 * d * d + 2 * rows * cfg["clip_dim"] * d
    head = 2 * rows * frames * d * c
    return embed + cfg["num_layers"] * layer_flops(rows, frames + 1, d, f) + head
