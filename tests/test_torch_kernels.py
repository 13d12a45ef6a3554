"""harkdb_tpu_torch kernels A-D: plain versions vs the JAX package.

The port's plain PyTorch versions (``flat_compact_reference``,
``flat_segscan_reference``, ``expand_fills_reference``,
``onehot_groupby_sums_reference``) are held against the Pallas kernels run
in interpret mode on the CPU (as tests/test_kernels.py runs them), against
the JAX doubling scan and against numpy oracles, on the same inputs made
with numpy from a seed.
Integer outputs and bit patterns must be identical; float32 add with
random values differs from the Pallas kernel only by summation order, so
those cases use integer-valued floats, whose sums are exact in any order.
The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from harkdb_tpu.kernels.compact import flat_compact as jax_flat_compact
from harkdb_tpu.kernels.expand import expand_fills as jax_expand_fills
from harkdb_tpu.kernels.matmul_agg import (
    onehot_groupby_sums as jax_onehot_groupby_sums,
)
from harkdb_tpu.kernels.segscan import flat_segscan as jax_flat_segscan
from harkdb_tpu.prims.segmented import doubling_segmented_scan

# one compile per (op, shape) instead of one per eager op and round
jax_doubling = jax.jit(doubling_segmented_scan, static_argnums=0)

from harkdb_tpu_torch.kernels import compact, expand, matmul_agg, segscan

SIZES = [1, 1000, 16384, 16385, 40000]
# Lengths around the CUDA kernels' 4096-row tiles.
TILE_LENGTHS = [1, 4095, 4096, 4097, 3 * 4096 + 5]
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
_JNP_OPS = {"add": jnp.add, "max": jnp.maximum, "min": jnp.minimum,
            "mul": jnp.multiply}


def _neutral(op, dtype):
    if op in ("add", "mul"):
        return 0 if op == "add" else 1
    if dtype == np.int32:
        return -(2**31) if op == "max" else 2**31 - 1
    info = np.finfo(np.float32)
    return float(info.min) if op == "max" else float(info.max)


def _edge_int32(rng, n) -> np.ndarray:
    x = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32)
    x[rng.random(n) < 0.05] = I32_MIN
    x[rng.random(n) < 0.05] = I32_MAX
    x[0] = (I32_MIN, I32_MAX)[n % 2]
    return x


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


class TestCompactReference:
    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("sel", [0.0, 0.5, 1.0])
    def test_vs_pallas_interpret(self, n, sel):
        rng = np.random.default_rng(n + int(sel * 10))
        k = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(
            np.int32)
        f = rng.standard_normal(n).astype(np.float32)
        f[rng.random(n) < 0.1] = np.nan
        f[rng.random(n) < 0.1] = -0.0
        mask = rng.random(n) < sel
        nv = max(0, n - 13)                       # n_valid < n
        got, cnt = compact.flat_compact_reference(
            {"k": torch.from_numpy(k), "f": torch.from_numpy(f)},
            torch.from_numpy(mask), torch.tensor(nv, dtype=torch.int32),
        )
        exp, ecnt = jax_flat_compact(
            {"k": jnp.asarray(k), "f": jnp.asarray(f)}, jnp.asarray(mask),
            jnp.int32(nv), interpret=True,
        )
        c = int(ecnt)
        assert int(cnt) == c
        assert cnt.dtype == torch.int32 and cnt.dim() == 0
        for name in ("k", "f"):
            assert got[name].shape == (n,)
            assert got[name].numpy().dtype == np.asarray(exp[name]).dtype
            np.testing.assert_array_equal(
                _bits(got[name].numpy()[:c]), _bits(np.asarray(exp[name])[:c])
            )

    @pytest.mark.parametrize("n", TILE_LENGTHS)
    @pytest.mark.parametrize("n_valid", ["n - 1", "n // 2"])
    def test_tile_lengths_vs_pallas_interpret(self, n, n_valid):
        """Count and packed rows with n_valid below n, at lengths around
        the CUDA kernel's tiles."""
        rng = np.random.default_rng(n)
        x = _edge_int32(rng, n)
        mask = rng.random(n) < 0.5
        nv = max(0, n - 1) if n_valid == "n - 1" else n // 2
        got, cnt = compact.flat_compact_reference(
            {"x": torch.from_numpy(x)}, torch.from_numpy(mask),
            torch.tensor(nv, dtype=torch.int32))
        exp, ecnt = jax_flat_compact({"x": jnp.asarray(x)}, jnp.asarray(mask),
                                     jnp.int32(nv), interpret=True)
        c = int(ecnt)
        assert int(cnt) == c == int((mask[:nv]).sum())
        np.testing.assert_array_equal(got["x"].numpy()[:c],
                                      np.asarray(exp["x"])[:c])

    def test_wrapper_takes_plain_version_on_cpu(self, rng):
        n = 5000
        cols = {"a": torch.from_numpy(rng.integers(0, 9, n).astype(np.int32))}
        mask = torch.from_numpy(rng.random(n) < 0.3)
        nv = torch.tensor(n, dtype=torch.int32)
        before = compact.LAUNCHES
        got, cnt = compact.flat_compact(cols, mask, nv)
        ref, rcnt = compact.flat_compact_reference(cols, mask, nv)
        assert compact.LAUNCHES == before       # no kernel launch on CPU
        assert int(cnt) == int(rcnt)
        assert torch.equal(got["a"], ref["a"])

    @pytest.mark.parametrize("bad", ["dtype", "shape", "mask", "n_valid",
                                     "device"])
    def test_wrapper_rejects(self, bad):
        n = 8
        cols = {"a": torch.zeros(n, dtype=torch.int32)}
        mask = torch.ones(n, dtype=torch.bool)
        nv = torch.tensor(n, dtype=torch.int32)
        if bad == "dtype":
            cols = {"a": torch.zeros(n, dtype=torch.int64)}
        elif bad == "shape":
            cols = {"a": torch.zeros(n + 1, dtype=torch.int32)}
        elif bad == "mask":
            mask = torch.ones(n, dtype=torch.int32)
        elif bad == "n_valid":
            nv = torch.tensor([n], dtype=torch.int32)
        else:
            cols = {"a": torch.zeros(n, dtype=torch.int32, device="meta")}
        with pytest.raises(ValueError):
            compact.flat_compact(cols, mask, nv)


class TestSegscanReference:
    @pytest.mark.parametrize("op", ["add", "max", "min", "mul"])
    @pytest.mark.parametrize("dtype", [np.int32, np.float32])
    def test_vs_pallas_interpret(self, op, dtype):
        """Segments crossing the Pallas kernel's 16384-row tiles, one
        segment spanning every tile, and sid -1 everywhere (no live row)."""
        n = 40000
        rng = np.random.default_rng(7)
        if op != "mul":
            x = rng.integers(-100, 100, n)       # exact as float32 sums too
        elif dtype == np.int32:
            x = rng.integers(-3, 4, n)           # wraps mod 2^32 in any order
        else:
            x = rng.choice([-1, 1], n)           # exact float products
        x = x.astype(dtype)
        layouts = [
            np.sort(rng.integers(0, 40, n)).astype(np.int32),
            np.zeros(n, np.int32),
            np.full(n, -1, np.int32),
        ]
        ne = _neutral(op, dtype)
        for sid in layouts:
            got = segscan.flat_segscan_reference(
                op, torch.from_numpy(sid), [torch.from_numpy(x)], ne
            )[0]
            exp = jax_flat_segscan(op, jnp.asarray(sid), [jnp.asarray(x)],
                                   ne, interpret=True)[0]
            np.testing.assert_array_equal(_bits(got.numpy()),
                                          _bits(np.asarray(exp)))

    @pytest.mark.parametrize("n,op", [
        (n, op) for n in SIZES for op in ("add", "max", "min", "mul")
        if n in (16385, 40000) or op in ("add", "max")
    ])
    def test_vs_doubling(self, n, op):
        """Live segment ids (>= 0): the plain version keeps the doubling
        order, so random float32 sums agree bit for bit too (rtol 1e-6
        states the contract; equality is what is observed)."""
        rng = np.random.default_rng(n)
        sid = np.sort(rng.integers(0, max(1, n // 30), n)).astype(np.int32)
        xi = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(
            np.int32)
        xf = rng.standard_normal(n).astype(np.float32)
        if op in ("max", "min"):
            xf[rng.random(n) < 0.02] = np.nan
        if op == "mul":
            xf = rng.uniform(0.9, 1.1, n).astype(np.float32)
        for x in (xi, xf):
            got = segscan.flat_segscan_reference(
                op, torch.from_numpy(sid), [torch.from_numpy(x)],
                _neutral(op, x.dtype),
            )[0].numpy()
            exp = np.asarray(jax_doubling(_JNP_OPS[op], jnp.asarray(sid),
                                          jnp.asarray(x)))
            if x.dtype == np.int32:
                np.testing.assert_array_equal(got, exp)
            else:
                np.testing.assert_allclose(got, exp, rtol=1e-6, atol=0)

    @pytest.mark.parametrize("reverse", [False, True])
    @pytest.mark.parametrize("op", ["max", "min"])
    @pytest.mark.parametrize("n", TILE_LENGTHS)
    def test_one_segment_vs_lax(self, n, op, reverse):
        """sid=None is one segment and reverse scans from the last row:
        the JAX package's lax.cummax / lax.cummin and
        jnp.flip(lax.cummin(jnp.flip(x))), on int32 edge values; the
        wrapper takes the same plain version on the CPU."""
        x = _edge_int32(np.random.default_rng(n), n)
        ne = _neutral(op, np.int32)
        scan = jax.lax.cummax if op == "max" else jax.lax.cummin
        xj = jnp.asarray(x)
        exp = np.asarray(jnp.flip(scan(jnp.flip(xj))) if reverse
                         else scan(xj))
        for fn in (segscan.flat_segscan_reference, segscan.flat_segscan):
            got = fn(op, None, [torch.from_numpy(x)], ne, reverse=reverse)[0]
            np.testing.assert_array_equal(got.numpy(), exp)

    @pytest.mark.parametrize("op", ["add", "max"])
    def test_reverse_with_sid_vs_pallas_interpret(self, op):
        """reverse=True with a sid that is non-decreasing from the last row
        to the first: the Pallas kernel on the flipped inputs, flipped."""
        n = 3 * 4096 + 5
        rng = np.random.default_rng(11)
        sid = np.sort(rng.integers(-1, 60, n)).astype(np.int32)[::-1].copy()
        x = rng.integers(-1000, 1000, n).astype(np.int32)
        ne = _neutral(op, np.int32)
        got = segscan.flat_segscan_reference(
            op, torch.from_numpy(sid), [torch.from_numpy(x)], ne,
            reverse=True)[0]
        exp = jax_flat_segscan(op, jnp.asarray(sid[::-1].copy()),
                               [jnp.asarray(x[::-1].copy())], ne,
                               interpret=True)[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp)[::-1])

    def test_multi_column(self, rng):
        n = 20000
        sid = np.sort(rng.integers(0, 50, n)).astype(np.int32)
        a = rng.standard_normal(n).astype(np.float32)
        b = rng.standard_normal(n).astype(np.float32)
        got = segscan.flat_segscan_reference(
            "max", torch.from_numpy(sid),
            [torch.from_numpy(a), torch.from_numpy(b)],
            float(np.finfo(np.float32).min),
        )
        exp = np.asarray(jax_doubling(jnp.maximum, jnp.asarray(sid),
                                      jnp.stack([a, b], axis=1)))
        np.testing.assert_array_equal(got[0].numpy(), exp[:, 0])
        np.testing.assert_array_equal(got[1].numpy(), exp[:, 1])

    def test_wrapper_takes_plain_version_on_cpu(self, rng):
        n = 3000
        sid = torch.from_numpy(np.sort(rng.integers(0, 9, n)).astype(np.int32))
        x = torch.from_numpy(rng.integers(0, 99, n).astype(np.int32))
        before = segscan.LAUNCHES
        got = segscan.flat_segscan("min", sid, [x], 2**31 - 1)[0]
        ref = segscan.flat_segscan_reference("min", sid, [x], 2**31 - 1)[0]
        assert segscan.LAUNCHES == before
        assert torch.equal(got, ref)

    @pytest.mark.parametrize("bad", ["op", "sid", "mixed", "dtype",
                                     "device"])
    def test_wrapper_rejects(self, bad):
        n = 8
        sid = torch.zeros(n, dtype=torch.int32)
        cols = [torch.zeros(n, dtype=torch.int32)]
        op = "max"
        if bad == "op":
            op = "xor"
        elif bad == "sid":
            sid = torch.zeros(n, dtype=torch.int64)
        elif bad == "mixed":
            cols = [torch.zeros(n, dtype=torch.int32),
                    torch.zeros(n, dtype=torch.float32)]
        elif bad == "dtype":
            cols = [torch.zeros(n, dtype=torch.float64)]
        else:
            sid = torch.zeros(n, dtype=torch.int32, device="meta")
            cols = [torch.zeros(n, dtype=torch.int32, device="meta")]
        with pytest.raises(ValueError):
            segscan.flat_segscan(op, sid, cols, 0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _nv(n: int) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


class TestExpandReference:
    """Kernel D's plain version vs the Pallas kernel in interpret mode and
    a numpy searchsorted oracle, on the cases of tests/test_kernels.py
    (TestExpandKernel). Only live slots (p < total) are specified."""

    BLOCK = 16384                       # the Pallas kernel's slot block

    @staticmethod
    def _oracle(offsets, n_src, out_cap):
        return np.maximum(np.searchsorted(offsets[:n_src], np.arange(out_cap),
                                          side="right") - 1, 0)

    CAP = 1 << 16            # one source capacity: one Pallas trace

    def _check(self, offsets, n_src, out_cap, extras, total):
        pad = self.CAP - offsets.shape[0]
        offsets = np.concatenate([offsets, np.zeros(pad, np.int32)])
        extras = [np.concatenate([e, np.zeros(pad, np.int32)])
                  for e in extras]
        seg, off_f, fills = expand.expand_fills_reference(
            _t(offsets), _nv(n_src), out_cap, [_t(e) for e in extras])
        jseg, joff, jfills = jax_expand_fills(
            jnp.asarray(offsets), jnp.int32(n_src), out_cap,
            tuple(jnp.asarray(e) for e in extras), interpret=True)
        live = np.arange(out_cap) < total
        want = self._oracle(offsets, n_src, out_cap)
        for got, pallas, oracle in (
            [(seg, jseg, want), (off_f, joff, offsets[want])]
            + [(f, jf, e[want]) for f, jf, e in zip(fills, jfills, extras)]
        ):
            assert got.dtype == torch.int32 and got.shape == (out_cap,)
            np.testing.assert_array_equal(got.numpy()[live],
                                          np.asarray(pallas)[live])
            np.testing.assert_array_equal(got.numpy()[live], oracle[live])

    @pytest.mark.parametrize("case", ["random", "unit", "one_big", "aligned"])
    def test_vs_pallas_interpret(self, rng, case):
        out_cap = 3 * self.BLOCK + 1000
        if case == "random":
            sizes = rng.integers(1, 9, 9000).astype(np.int32)
        elif case == "unit":
            sizes = np.ones(out_cap - 5, np.int32)
        elif case == "one_big":
            sizes = np.array([out_cap + 7], np.int32)
        else:                  # segments starting exactly at block edges
            sizes = np.full(6, self.BLOCK, np.int32)
        offsets = (np.cumsum(sizes) - sizes).astype(np.int32)
        ends = (offsets + sizes).astype(np.int32)
        self._check(offsets, len(sizes), out_cap, [ends], int(sizes.sum()))

    def test_padded_source_capacity(self, rng):
        """Entries at index >= n_src are ignored (engine padding)."""
        sizes = rng.integers(1, 30, 500).astype(np.int32)
        offsets = (np.cumsum(sizes) - sizes).astype(np.int32)
        n_src = 300
        padded = np.concatenate([offsets, np.zeros(2048, np.int32)])
        out_cap = int(offsets[n_src - 1] + sizes[n_src - 1]) + 77
        self._check(padded, n_src, out_cap, [],
                    int(sizes[:n_src].sum()))

    def test_random_small_trials(self, rng):
        for _trial in range(8):
            n_seg = int(rng.integers(1, 200))
            sizes = rng.integers(1, 400, n_seg).astype(np.int32)
            offsets = (np.cumsum(sizes) - sizes).astype(np.int32)
            total = int(sizes.sum())
            # one output capacity for every trial (one Pallas trace); the
            # slots past total + a random margin are not compared
            live_cap = total + int(rng.integers(0, 300))
            mono = np.minimum(offsets // 2, 1 << 20).astype(np.int32)
            self._check(offsets, n_seg, 80_000 + 300, [mono],
                        min(total, live_cap))

    # The CUDA kernel's tile edges (expand.TILE output slots a block).
    TILE = expand.TILE

    @pytest.mark.parametrize("cap", ["T-1", "T", "T+1", "3T+5"])
    def test_tile_edges_vs_pallas(self, rng, cap):
        t = self.TILE
        out_cap = {"T-1": t - 1, "T": t, "T+1": t + 1, "3T+5": 3 * t + 5}[cap]
        sizes = rng.integers(1, 9, out_cap // 4 + 3).astype(np.int32)
        offsets = (np.cumsum(sizes) - sizes).astype(np.int32)
        self._check(offsets, len(sizes), out_cap, [offsets + sizes, offsets],
                    min(out_cap, int(sizes.sum())))

    @pytest.mark.parametrize("layout", ["one_segment_over_tiles",
                                        "unit_segments_fill_tiles",
                                        "late_first_offset", "n_src_is_cap"])
    def test_tile_layouts_vs_pallas(self, rng, layout):
        t = self.TILE
        out_cap = 3 * t + 5
        if layout == "one_segment_over_tiles":
            sizes = np.array([7, 3 * t - 20, 9], np.int32)
        elif layout == "unit_segments_fill_tiles":
            sizes = np.ones(2 * t, np.int32)
        else:
            sizes = rng.integers(1, 9, t).astype(np.int32)
        offsets = (np.cumsum(sizes) - sizes).astype(np.int32)
        total = int(sizes.sum())
        if layout == "late_first_offset":       # offsets[0] > 0
            offsets = offsets + 1000
            total += 1000
        ends = offsets + sizes
        if layout == "n_src_is_cap":             # no padding past n_src
            seg, off_f, fills = expand.expand_fills_reference(
                _t(offsets), _nv(len(sizes)), out_cap, [_t(ends)])
            want = self._oracle(offsets, len(sizes), out_cap)
            np.testing.assert_array_equal(seg.numpy(), want)
            np.testing.assert_array_equal(off_f.numpy(), offsets[want])
            np.testing.assert_array_equal(fills[0].numpy(), ends[want])
        self._check(offsets, len(sizes), out_cap, [ends],
                    min(out_cap, total))

    @pytest.mark.parametrize("n_planes", [0, 2, 8])
    def test_extra_planes_vs_pallas(self, rng, n_planes):
        t = self.TILE
        sizes = rng.integers(1, 6, 2 * t).astype(np.int32)
        offsets = (np.cumsum(sizes) - sizes).astype(np.int32)
        planes = [np.cumsum(rng.integers(0, 5, len(sizes))).astype(np.int32)
                  for _ in range(n_planes)]
        self._check(offsets, len(sizes), 3 * t + 5, planes,
                    min(3 * t + 5, int(sizes.sum())))

    @pytest.mark.parametrize("layout", ["empty_runs", "empty_run_over_a_tile"])
    def test_empty_segments_vs_searchsorted(self, rng, layout):
        """Equal offsets are outside the Pallas kernel's contract; the
        plain version (and the CUDA kernel, on the card) give the last of
        the equal entries, as np.searchsorted(side="right") does."""
        t = self.TILE
        if layout == "empty_runs":
            sizes = np.where(rng.random(3 * t) < 0.3, 0,
                             rng.integers(1, 4, 3 * t)).astype(np.int32)
        else:
            sizes = np.concatenate([np.ones(t // 2), np.zeros(2 * t + 1),
                                    np.ones(t)]).astype(np.int32)
        offsets = (np.cumsum(sizes) - sizes).astype(np.int32)
        ends = (offsets + sizes).astype(np.int32)
        out_cap = int(sizes.sum()) + t // 3
        seg, off_f, fills = expand.expand_fills_reference(
            _t(offsets), _nv(len(sizes)), out_cap, [_t(ends)])
        want = self._oracle(offsets, len(sizes), out_cap)
        np.testing.assert_array_equal(seg.numpy(), want)
        np.testing.assert_array_equal(off_f.numpy(), offsets[want])
        np.testing.assert_array_equal(fills[0].numpy(), ends[want])

    def test_no_source_fills_every_plane(self, rng):
        offsets = np.arange(0, 40, 4, dtype=np.int32)
        planes = [rng.integers(0, 99, 10).astype(np.int32) for _ in range(8)]
        seg, off_f, fills = expand.expand_fills_reference(
            _t(offsets), _nv(0), 2 * self.TILE + 1, [_t(p) for p in planes])
        assert not seg.any() and (off_f == 2**31 - 1).all()
        for f, p in zip(fills, planes):
            assert (f == int(p[0])).all()

    def test_no_source_and_expand_ids(self):
        offsets = np.array([0, 3, 9], np.int32)
        seg, off_f, fills = expand.expand_fills_reference(
            _t(offsets), _nv(0), 16, [_t(offsets)])
        assert seg.tolist() == [0] * 16
        assert off_f.tolist() == [2**31 - 1] * 16      # dead entries
        ids = expand.expand_ids(_t(offsets), _nv(3), 12)
        assert ids.tolist() == [0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2]

    def test_wrapper_takes_plain_version_on_cpu(self, rng):
        sizes = rng.integers(1, 9, 700).astype(np.int32)
        offsets = _t((np.cumsum(sizes) - sizes).astype(np.int32))
        before = expand.LAUNCHES
        got = expand.expand_fills(offsets, _nv(700), 5000, [offsets])
        ref = expand.expand_fills_reference(offsets, _nv(700), 5000,
                                            [offsets])
        assert expand.LAUNCHES == before
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert torch.equal(got[2][0], ref[2][0])

    @pytest.mark.parametrize("bad", ["dtype", "n_src", "extra", "capacity",
                                     "empty", "device"])
    def test_wrapper_rejects(self, bad):
        offs = torch.arange(8, dtype=torch.int32)
        nv, cap, extras = _nv(8), 16, [offs]
        if bad == "empty":
            offs, extras = torch.zeros(0, dtype=torch.int32), []
        elif bad == "dtype":
            offs = offs.to(torch.int64)
        elif bad == "n_src":
            nv = torch.tensor([8], dtype=torch.int32)
        elif bad == "extra":
            extras = [torch.arange(9, dtype=torch.int32)]
        elif bad == "capacity":
            cap = -1
        else:
            offs = torch.arange(8, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError):
            expand.expand_fills(offs, nv, cap, extras)


class TestOnehotReference:
    """Kernel C's plain version vs the Pallas kernel in interpret mode on
    the cases of tests/test_kernels.py (TestOnehotGroupby): counts, sums
    and keys bit for bit."""

    def _check(self, k, cols, n_valid, key_min, span, mask=None):
        got = matmul_agg.onehot_groupby_sums_reference(
            _t(k), [_t(c) for c in cols], _nv(n_valid), key_min, span,
            mask=None if mask is None else _t(mask))
        want = jax_onehot_groupby_sums(
            jnp.asarray(k), [jnp.asarray(c) for c in cols],
            jnp.int32(n_valid), jnp.int32(key_min), span,
            mask=None if mask is None else jnp.asarray(mask), interpret=True)
        for g, w in zip([got[0], *got[1], got[2]],
                        [want[0], *want[1], want[2]]):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), w)
        return got

    def test_values_in_a_million(self, rng):
        n = 6000
        k = rng.integers(10, 200, n).astype(np.int32)
        v = rng.integers(-(10**6), 10**6, n).astype(np.int32)
        self._check(k, [v], n, 10, 191)

    def test_mask_and_n_valid(self, rng):
        n = 3000
        k = rng.integers(0, 50, n).astype(np.int32)
        mask = rng.random(n) < 0.5
        counts, _sums, _axis = self._check(k, [np.ones(n, np.int32)], 2000,
                                           0, 50, mask)
        np.testing.assert_array_equal(
            counts.numpy(), np.bincount(k[:2000][mask[:2000]], minlength=50))

    def test_int32_sum_wraps_to_zero(self):
        _c, sums, _a = self._check(np.zeros(4, np.int32),
                                   [np.full(4, 2**30, np.int32)], 4, 0, 1)
        assert int(sums[0][0]) == 0          # 4 * 2^30 = 2^32 ≡ 0

    def test_span_one(self, rng):
        n = 5000
        k = rng.integers(3, 6, n).astype(np.int32)       # keys 4, 5 excluded
        self._check(k, [rng.integers(-99, 99, n).astype(np.int32)], n, 3, 1)

    def test_two_sum_columns_and_negative_keys(self, rng):
        n = 4000
        k = rng.integers(-40, 40, n).astype(np.int32)
        a = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(
            np.int32)
        b = rng.integers(0, 9, n).astype(np.int32)
        self._check(k, [a, b], n - 7, -30, 1024, rng.random(n) < 0.7)

    @pytest.mark.parametrize("case", ["n_valid_0", "all_rows_masked",
                                      "keys_outside_negative_min",
                                      "hot_key_90pct"])
    def test_edge_cases_vs_pallas(self, rng, case):
        n = 5000
        k = rng.integers(0, 64, n).astype(np.int32)
        v = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(
            np.int32)
        mask, nv, kmin, span = rng.random(n) < 0.8, n, 0, 64
        if case == "n_valid_0":
            nv = 0
        elif case == "all_rows_masked":
            mask = np.zeros(n, bool)
        elif case == "keys_outside_negative_min":
            k = rng.integers(-3000, 3000, n).astype(np.int32)
            kmin, span = -1000, 1024
        else:
            k = np.where(rng.random(n) < 0.9, 17, k).astype(np.int32)
        counts, _sums, _axis = self._check(k, [v], nv, kmin, span, mask)
        if case in ("n_valid_0", "all_rows_masked"):
            assert not counts.any()

    @pytest.mark.parametrize("n_cols", [3, 32])
    def test_wide_span_many_columns_vs_pallas(self, rng, n_cols):
        n = 600
        k = rng.integers(-5, 16390, n).astype(np.int32)
        cols = [rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(
            np.int32) for _ in range(n_cols)]
        self._check(k, cols, n, 0, 16384)

    # Row counts at the CUDA kernel's edges: 4 rows a thread, a CTA per 8192
    # rows, clusters of up to 8 CTAs.
    @pytest.mark.parametrize("n", [1, 5, 8191, 8192, 8193, 65537])
    def test_row_count_edges_vs_pallas(self, rng, n):
        k = rng.integers(-10, 80, n).astype(np.int32)
        v = rng.integers(-99, 99, n).astype(np.int32)
        self._check(k, [v], max(0, n - 3), 0, 64, rng.random(n) < 0.7)

    SMEM_OPTIN = 232448                 # an H100's opt-in shared memory

    @pytest.mark.parametrize("span,n_cols,plan", [
        (4096, 1, (0, 8, 0, 2)),            # the star join: replicated
        (1, 1, (0, 8, 0, 2)),
        (16384, 1, (0, 8, 0, 2)),           # 128 KB fits one CTA
        (16384, 3, (2, 2, 0, 2)),           # 256 KB: two columns a CTA
        (1024, 32, (0, 8, 0, 33)),          # 132 KB: one CTA
        (8192, 7, (1, 2, 12, 8)),           # 256 KB, too many columns
        (16384, 32, (1, 8, 11, 19)),        # 19 of 33 columns in shared
    ])
    def test_plan_by_shape(self, span, n_cols, plan):
        assert matmul_agg.dense_agg_plan(span, n_cols,
                                         self.SMEM_OPTIN) == plan

    def test_plans_fit_and_cover(self):
        agg = matmul_agg
        budget = self.SMEM_OPTIN - agg.STAGE_BYTES
        for span in (1, 2, 3, 50, 191, 1000, 1024, 4095, 4096, 8193, 16384):
            for n_cols in (0, 1, 2, 3, 8, 31, 32):
                shape, cluster, shift, held = agg.dense_agg_plan(
                    span, n_cols, self.SMEM_OPTIN)
                assert cluster in (1, 2, 4, 8) and 0 <= held <= n_cols + 1
                if shape == agg.SPLIT_KEYS:
                    assert cluster << shift >= span
                    assert 4 * held << shift <= budget
                    assert held == n_cols + 1 or cluster == 8
                elif shape == agg.SPLIT_COLUMNS:
                    assert (cluster, held) == (2, 2)
                    assert n_cols + 1 <= agg.COLUMN_PAIR_COLS
                    assert 8 * span <= budget
                else:
                    assert shape == agg.REPLICATED and held == n_cols + 1
                    assert 4 * held * span <= budget

    @pytest.mark.parametrize("shape,cluster", [
        (0, 1), (0, 8), (1, 2), (1, 4), (1, 8), (2, 2)])
    def test_forced_plans_fit(self, shape, cluster):
        """A plan forced by shape and cluster size (the card's edge cases
        run every histogram shape) fits, or is None where it cannot."""
        agg = matmul_agg
        budget = self.SMEM_OPTIN - agg.STAGE_BYTES
        for span in (1, 50, 1024, 4096, 8193, 16384):
            for n_cols in (0, 1, 3, 8, 32):
                plan = agg.shape_plan(shape, cluster, span, n_cols,
                                      self.SMEM_OPTIN)
                if plan is None:
                    assert shape != agg.SPLIT_KEYS
                    continue
                got_shape, got_cluster, shift, held = plan
                assert (got_shape, got_cluster) == (shape, cluster)
                if shape == agg.SPLIT_KEYS:
                    assert cluster << shift >= span
                    assert 0 < 4 * held << shift <= budget
                elif shape == agg.SPLIT_COLUMNS:
                    assert n_cols + 1 <= agg.COLUMN_PAIR_COLS
                    assert 8 * span <= budget
                else:
                    assert 4 * (n_cols + 1) * span <= budget
                if plan[:2] == agg.dense_agg_plan(span, n_cols,
                                                  self.SMEM_OPTIN)[:2]:
                    assert plan == agg.dense_agg_plan(span, n_cols,
                                                      self.SMEM_OPTIN)

    def test_applicability(self):
        assert matmul_agg.matmul_agg_applicable(["sum", "count"], 1000)
        assert not matmul_agg.matmul_agg_applicable(["max"], 1000)
        assert not matmul_agg.matmul_agg_applicable(["sum"], 10**6)
        assert matmul_agg.MAX_KEY_SPAN == 16384
        assert matmul_agg.KEY_TILE == 1024

    def test_wrapper_takes_plain_version_on_cpu(self, rng):
        n = 2000
        k = _t(rng.integers(0, 64, n).astype(np.int32))
        v = _t(rng.integers(-9, 9, n).astype(np.int32))
        before = matmul_agg.LAUNCHES
        got = matmul_agg.onehot_groupby_sums(k, [v], _nv(n), 0, 64)
        ref = matmul_agg.onehot_groupby_sums_reference(k, [v], _nv(n), 0, 64)
        assert matmul_agg.LAUNCHES == before
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1][0],
                                                            ref[1][0])

    @pytest.mark.parametrize("bad", ["key", "value", "key_min", "span",
                                     "mask", "device"])
    def test_wrapper_rejects(self, bad):
        k = torch.zeros(8, dtype=torch.int32)
        cols, kmin, span, mask = [torch.zeros(8, dtype=torch.int32)], 0, 4, None
        if bad == "key":
            k = k.to(torch.float32)
        elif bad == "value":
            cols = [torch.zeros(7, dtype=torch.int32)]
        elif bad == "key_min":
            kmin = torch.tensor(0)
        elif bad == "span":
            span = 0
        elif bad == "mask":
            mask = torch.ones(8, dtype=torch.int32)
        else:
            k = torch.zeros(8, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError):
            matmul_agg.onehot_groupby_sums(k, cols, _nv(8), kmin, span,
                                           mask=mask)
