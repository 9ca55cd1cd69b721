"""Packing pass helpers: tile-format weight layouts and zero padding.

The paper's Packing stage "reorganizes quantized stationary tensors (weights
and biases) into tiled and aligned layouts compatible with the formats
expected by AIE intrinsics". For aie::mmul<M,K,N>, a weight slice must be
streamed as contiguous K x N tiles; arbitrary layer dimensions are zero-padded
to tile multiples (the memory-tile DMA injects the zeros on hardware — here
the pack step materializes them so kernels never see ragged edges).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def pad2d(w: np.ndarray, k_pad: int, n_pad: int) -> np.ndarray:
    """Zero-pad a (K, N) matrix up to (k_pad, n_pad)."""
    out = np.zeros((k_pad, n_pad), dtype=w.dtype)
    out[: w.shape[0], : w.shape[1]] = w
    return out


def tile_interleave(w: np.ndarray, K: int, N: int) -> np.ndarray:
    """Rearrange a padded (Kp, Np) matrix into contiguous mmul tiles:
    result[kt, nt, K, N] — the stream order aie::mmul consumes."""
    Kp, Np = w.shape
    assert Kp % K == 0 and Np % N == 0
    return (
        w.reshape(Kp // K, K, Np // N, N).transpose(0, 2, 1, 3).copy()
    )


def pack_dense_weight(
    w_q: np.ndarray,
    cas_len: int,
    cas_num: int,
    f_in_slice: int,
    f_out_slice: int,
    K: int,
    N: int,
) -> Dict[str, np.ndarray]:
    """Pack a quantized (f_in, f_out) weight into per-tile mmul tile streams.

    Returns:
      packed:  [cas_num, cas_len, kt, nt, K, N] integer array — the exact
               per-tile buffers loaded once via RTP and resident on-chip.
      padded:  the zero-padded (K_pad, N_pad) matrix (oracle layout).
    """
    f_in, f_out = w_q.shape
    k_pad, n_pad = cas_len * f_in_slice, cas_num * f_out_slice
    if k_pad < f_in or n_pad < f_out:
        raise ValueError("cascade slices do not cover the layer dimensions")
    if f_in_slice % K or f_out_slice % N:
        raise ValueError("slices must be multiples of the mmul tile dims")
    padded = pad2d(w_q, k_pad, n_pad)
    # split into cascade slices, then tile-interleave each slice
    sliced = padded.reshape(cas_len, f_in_slice, cas_num, f_out_slice)
    sliced = sliced.transpose(2, 0, 1, 3)  # [cas_num, cas_len, f_in_s, f_out_s]
    kt, nt = f_in_slice // K, f_out_slice // N
    packed = np.empty((cas_num, cas_len, kt, nt, K, N), dtype=w_q.dtype)
    for r in range(cas_num):
        for c in range(cas_len):
            packed[r, c] = tile_interleave(sliced[r, c], K, N)
    return {"packed": packed, "padded": padded}


def pack_bias(
    b_q: np.ndarray, cas_num: int, f_out_slice: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad and slice a quantized bias across cascade rows.

    Bias is loaded into the accumulators in the kernel prologue, so it lives
    at accumulator precision, sliced per cascade row: [cas_num, f_out_slice].
    """
    n_pad = cas_num * f_out_slice
    padded = np.zeros((n_pad,), dtype=b_q.dtype)
    padded[: b_q.shape[0]] = b_q
    return padded.reshape(cas_num, f_out_slice), padded
