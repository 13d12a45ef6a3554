"""The card's peak and the bytes each hand-written kernel's work needs.

The byte counts follow the rule the kernel table of the port uses: each
input byte the call's work needs read once, each output byte written once,
over the H100 SXM's HBM3 rate (NVIDIA's data sheet). A count that needs a
value on the card (a kept-row count, a live-segment count) takes the 0-d
tensor the call already made, read after the measured window.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12

# Substrings of the kernels' names in a profiler trace (csrc/*.cu).
KERNEL_NAMES = {
    "flat_compact": ("compact_kernel",),
    "flat_segscan": ("segscan_kernel",),
    "expand_fills": ("expand_kernel",),
    "onehot_groupby_sums": ("dense_agg_kernel", "dense_agg_cols_kernel"),
}


def compact_bytes(n_valid: int, n_cols: int, kept: int) -> int:
    """Kernel A: the mask over the live rows read, each kept word of each
    column read and written."""
    return n_valid + n_cols * 8 * kept


def segscan_bytes(n: int, n_cols: int, elem: int, has_sid: bool) -> int:
    """Kernel B: segment ids and every column read, every column written."""
    return (4 * n if has_sid else 0) + 2 * n_cols * n * elem


def expand_bytes(n_src: int, out_cap: int, n_extras: int) -> int:
    """Kernel D: offsets and each extra plane over the live segments in,
    seg, the offset fill and each plane's fill out."""
    return 4 * n_src * (1 + n_extras) + 4 * out_cap * (2 + n_extras)


def dense_agg_bytes(n: int, n_cols: int, masked: bool, span: int) -> int:
    """Kernel C: key, mask and value columns in, counts, sums and the key
    axis out."""
    return 4 * n * (1 + n_cols) + (n if masked else 0) + 4 * span * (2 + n_cols)
