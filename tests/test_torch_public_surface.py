"""harkdb_tpu_torch's public surface against harkdb_tpu's, on the CPU.

Every name the JAX package exports (each subpackage's ``__all__``), every
public class and function its modules define, the public members of its
``Context``, ``Table``, ``ColumnBatch`` and ``ShardedBatch`` and the fields
of its ``EngineConfig`` have a counterpart in the port under the same name,
but for ``LEFT_OUT``: JAX or TPU mechanisms the port's design replaces,
each with its reason. Then the rules the port adds at that surface: its
entry points put data on the card unless asked for the CPU, and raise when
there is none; importing ``kernels`` builds and loads nothing. Then the
names this surface gained, held against the JAX package on the same inputs
made by numpy from a seed: ``ops.AGG_FUNCS``, the kernels' contract
predicates and ``__graft_entry__.entry()``'s step, run through the port's
``ops`` and ``prims`` as ``chip_smoke.entry_step``.
"""

import dataclasses
import importlib
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import harkdb_tpu
import harkdb_tpu.kernels.compact as JC
import harkdb_tpu.kernels.segscan as JS
import harkdb_tpu.ops as JO
import harkdb_tpu_torch
import harkdb_tpu_torch.kernels.compact as TC
import harkdb_tpu_torch.kernels.segscan as TS
import harkdb_tpu_torch.ops as TO
from harkdb_tpu_torch.columnar.batch import ColumnBatch

import __graft_entry__
import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Public names of the JAX package the port does not have, by design.
LEFT_OUT = {
    "harkdb_tpu.parallel.row_spec":
        "a jax.sharding PartitionSpec; a rank of the port holds its block "
        "of each table as plain tensors",
    "harkdb_tpu.parallel.row_sharding":
        "a jax.sharding NamedSharding, as row_spec",
    "harkdb_tpu.parallel.mesh.row_spec": "the same function, where defined",
    "harkdb_tpu.parallel.mesh.row_sharding":
        "the same function, where defined",
    "harkdb_tpu.parallel.mesh.AXIS":
        "the mesh axis name of jax.sharding; torch.distributed has ranks",
    "harkdb_tpu.Table.sharding":
        "a jax.sharding object; a torch tensor has no sharding",
    "harkdb_tpu.columnar.batch.ColumnBatch.tree_flatten":
        "JAX's pytree hook for jit; torch passes objects as they are",
    "harkdb_tpu.columnar.batch.ColumnBatch.tree_unflatten":
        "JAX's pytree hook, as tree_flatten",
    "harkdb_tpu.parallel.sharded.ShardedBatch.tree_flatten":
        "JAX's pytree hook, as for ColumnBatch",
    "harkdb_tpu.parallel.sharded.ShardedBatch.tree_unflatten":
        "JAX's pytree hook, as for ColumnBatch",
    "harkdb_tpu.EngineConfig.use_pallas":
        "a switch between the Pallas kernels and XLA; the port's wrappers "
        "launch their kernel for every CUDA tensor, with no switch",
    "harkdb_tpu.parallel.dist_ops.ShuffleOverflow":
        "the overflow of JAX's static exchange buckets; the port's "
        "exchange sends split sizes first and cannot overflow",
    "harkdb_tpu.parallel.shuffle.compact_received":
        "packs JAX's static buckets after the exchange; the split-size "
        "exchange receives packed rows",
}

SUBPACKAGES = ["", "ops", "kernels", "prims", "parallel", "columnar",
               "plan", "sql", "utils"]
JAX_MODULES = sorted(
    m.name for m in pkgutil.walk_packages(harkdb_tpu.__path__, "harkdb_tpu.")
    if not m.name.endswith("__main__"))


def _pair(sub: str):
    suffix = f".{sub}" if sub else ""
    return (importlib.import_module("harkdb_tpu" + suffix),
            importlib.import_module("harkdb_tpu_torch" + suffix))


def _check_names(jax_qual: str, names, port_obj) -> None:
    """Each of ``names`` exists on ``port_obj`` unless ``LEFT_OUT`` lists
    ``jax_qual.name``; a listed name must be absent (the list stays
    true)."""
    missing = [n for n in names if f"{jax_qual}.{n}" not in LEFT_OUT
               and not hasattr(port_obj, n)]
    assert missing == [], f"{jax_qual}: no counterpart for {missing}"
    stale = [n for n in names if f"{jax_qual}.{n}" in LEFT_OUT
             and hasattr(port_obj, n)]
    assert stale == [], f"LEFT_OUT names {stale}, which the port has"


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "root")
def test_every_exported_name_imports_from_the_port(sub):
    jax_mod, port_mod = _pair(sub)
    _check_names(jax_mod.__name__, jax_mod.__all__, port_mod)
    for name in jax_mod.__all__:
        if f"{jax_mod.__name__}.{name}" not in LEFT_OUT:
            exec(f"from {port_mod.__name__} import {name}", {})


@pytest.mark.parametrize("name", JAX_MODULES)
def test_every_module_defines_the_same_public_names(name):
    """Each public class and function a JAX module defines (not merely
    imports) exists in the port's module of the same path. Constants are
    left out: the Pallas kernels' tile shapes (``BLOCK``, ``LANES``, ...)
    are theirs alone, as the CUDA kernels' are."""
    jax_mod = importlib.import_module(name)
    port_mod = importlib.import_module(
        name.replace("harkdb_tpu", "harkdb_tpu_torch", 1))
    names = [n for n, v in vars(jax_mod).items() if not n.startswith("_")
             and getattr(v, "__module__", None) == name]
    _check_names(name, names, port_mod)


@pytest.mark.parametrize("qual", [
    "harkdb_tpu.Context", "harkdb_tpu.Table",
    "harkdb_tpu.columnar.batch.ColumnBatch",
    "harkdb_tpu.parallel.sharded.ShardedBatch",
])
def test_classes_have_the_same_public_members(qual):
    mod, cls = qual.rsplit(".", 1)
    jax_cls = getattr(importlib.import_module(mod), cls)
    port_cls = getattr(importlib.import_module(
        mod.replace("harkdb_tpu", "harkdb_tpu_torch", 1)), cls)
    _check_names(qual, [n for n in dir(jax_cls) if not n.startswith("_")],
                 port_cls)


def test_engine_config_has_the_same_fields():
    port = harkdb_tpu_torch.EngineConfig()
    _check_names("harkdb_tpu.EngineConfig",
                 [f.name for f in dataclasses.fields(harkdb_tpu.EngineConfig)],
                 port)


def test_left_out_names_exist_in_the_jax_package():
    for qual in LEFT_OUT:
        mod, name = qual.rsplit(".", 1)
        try:
            obj = importlib.import_module(mod)
        except ImportError:                     # a class, not a module
            mod, cls = mod.rsplit(".", 1)
            obj = getattr(importlib.import_module(mod), cls)
        if dataclasses.is_dataclass(obj):
            assert name in {f.name for f in dataclasses.fields(obj)}, qual
        else:
            assert hasattr(obj, name), qual


# -- the device rule ------------------------------------------------------------

def _make(entry: str, device):
    data = {"k": np.arange(5, dtype=np.int32),
            "v": np.linspace(0, 1, 5).astype(np.float32)}
    kw = {} if device is None else {"device": device}
    if entry == "Context":
        return harkdb_tpu_torch.Context(**kw)
    if entry == "Table":
        return harkdb_tpu_torch.Table("t", data, **kw)
    if entry == "Table.from_host":
        return harkdb_tpu_torch.Table.from_host("t", data, ["k", "v"], {},
                                                **kw)
    if entry == "tables_from_reference":
        j = harkdb_tpu.Table("t", data)
        return harkdb_tpu_torch.tables_from_reference({"t": j}, **kw)["t"]
    return ColumnBatch.from_numpy(data, **kw)


ENTRIES = ["Context", "Table", "Table.from_host", "tables_from_reference",
           "ColumnBatch.from_numpy"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_default_to_the_card_and_raise_without_one(
        entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as e:
        _make(entry, None)
    assert str(e.value) == (
        f"{entry}(device='cuda') needs a CUDA device and none is "
        f"available; pass device='cpu' to run on the CPU")
    with pytest.raises(RuntimeError, match=r"^" + entry.replace(".", r"\.")):
        _make(entry, "cuda:0")
    with pytest.raises(ValueError, match="unsupported device meta"):
        _make(entry, "meta")
    made = _make(entry, "cpu")
    assert made.device == torch.device("cpu")


def test_kernels_import_builds_and_loads_nothing():
    """A fresh process imports torch, then the package and ``kernels`` with
    ctypes' loader and process start-up made to raise: nothing is built or
    loaded until a kernel launches."""
    code = (
        "import ctypes, subprocess, numpy, torch\n"
        "def boom(*a, **k): raise AssertionError('loaded at import')\n"
        "ctypes.CDLL = subprocess.Popen = subprocess.run = boom\n"
        "import harkdb_tpu_torch, harkdb_tpu_torch.kernels as K\n"
        "from harkdb_tpu_torch.kernels import _lib\n"
        "assert _lib._lib is None\n"
        "assert K.onehot_groupby_sums and K.matmul_agg_applicable\n"
        "print(sorted(K.__all__))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['matmul_agg_applicable', " \
                                 "'onehot_groupby_sums']"


# -- AGG_FUNCS and the contract predicates ---------------------------------------

def _pairs(dtype):
    rng = np.random.default_rng(21)
    if dtype == np.int32:
        a = rng.integers(-2**31, 2**31 - 1, 300, dtype=np.int64)
        b = rng.integers(-2**31, 2**31 - 1, 300, dtype=np.int64)
        a[:4] = [2**31 - 1, -2**31, 65536, -1]       # wrap on add and mul
        b[:4] = [1, -1, 65536, -2**31]
        return a.astype(np.int32), b.astype(np.int32)
    a = rng.standard_normal(300).astype(np.float32) * 1e3
    b = rng.standard_normal(300).astype(np.float32) * 1e3
    a[:4] = [np.nan, np.inf, -0.0, 3.0e38]
    b[:4] = [1.0, -np.inf, 0.0, 3.0e38]
    return a, b


@pytest.mark.parametrize("dtype", [np.int32, np.float32],
                         ids=["int32", "float32"])
@pytest.mark.parametrize("op", sorted(JO.AGG_FUNCS))
def test_agg_funcs_compute_what_jax_does(op, dtype):
    assert sorted(TO.AGG_FUNCS) == sorted(JO.AGG_FUNCS)
    a, b = _pairs(dtype)
    want = np.asarray(JO.AGG_FUNCS[op](jnp.asarray(a), jnp.asarray(b)))
    got = TO.AGG_FUNCS[op](torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == want.dtype
    # Equal values, NaN where JAX has NaN. Not bit for bit: the float max /
    # min of -0.0 and 0.0 and the NaN they return carry other sign bits in
    # torch than in XLA, and SQL tells neither apart.
    np.testing.assert_array_equal(got, want)


DTYPES = {"int32": (np.int32, torch.int32),
          "float32": (np.float32, torch.float32),
          "int64": (np.int64, torch.int64),
          "float64": (np.float64, torch.float64),
          "bool": (np.bool_, torch.bool)}
# Where the port's predicate answers otherwise than the JAX package's: the
# JAX kernels take uint32, the port's do not; no table of either package
# holds a uint32 column (ROADMAP §3).
PREDICATE_DIFFERENCES = {"uint32": (np.uint32, torch.uint32)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", ["add", "max", "min", "mul", "sum", "xor"])
def test_segscan_supported_agrees_with_jax(op, dtype):
    np_dt, torch_dt = DTYPES[dtype]
    assert TS.segscan_supported(op, torch_dt) == \
        JS.segscan_supported(op, np_dt)


def _cols(dtypes, lib):
    return {f"c{i}": (np.zeros(2, dt[0]) if lib == "np"
                      else torch.zeros(2, dtype=dt[1]))
            for i, dt in enumerate(dtypes)}


@pytest.mark.parametrize("names", [
    [], ["int32"], ["float32"], ["int64"], ["float64"], ["bool"],
    ["int32", "float32"], ["int32", "int64"], ["float32", "bool"],
], ids=lambda n: "+".join(n) or "none")
def test_flat_compact_supported_agrees_with_jax(names):
    dts = [DTYPES[n] for n in names]
    assert TC.flat_compact_supported(_cols(dts, "torch")) == \
        JC.flat_compact_supported(_cols(dts, "np"))


def test_predicates_differ_from_jax_on_uint32_only():
    np_dt, torch_dt = PREDICATE_DIFFERENCES["uint32"]
    for op in ("add", "max", "min", "mul"):
        assert JS.segscan_supported(op, np_dt)
        assert not TS.segscan_supported(op, torch_dt)
    assert JC.flat_compact_supported(_cols([(np_dt, torch_dt)], "np"))
    assert not TC.flat_compact_supported(_cols([(np_dt, torch_dt)], "torch"))


def test_wrappers_refuse_what_the_predicates_refuse():
    x = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32 or all float32"):
        TS.flat_segscan("add", None, [x], 0)
    with pytest.raises(ValueError, match="int32/float32 words only"):
        TC.flat_compact({"x": x}, torch.ones(4, dtype=torch.bool),
                        torch.tensor(4, dtype=torch.int32))


# -- __graft_entry__.entry()'s step through the port ------------------------------

@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_entry_step_matches_graft_entry(jit):
    """``entry()``'s own inputs (8192 rows, keys in [0, 256)) through its
    ``query_step`` in JAX on the CPU and through ``chip_smoke.entry_step``
    (the port's ``prims.compact_batch`` and ``ops.groupby_batch``) on CPU
    tensors: the same groups, sums, maxima and counts bit for bit."""
    fn, args = __graft_entry__.entry()
    want = (jax.jit(fn) if jit else fn)(*args)
    keys, vals, n = (np.array(a) for a in args)
    batch = ColumnBatch.from_numpy({"k": keys, "v": vals}, device="cpu")
    assert int(batch.n_valid) == int(n) == 8192
    got = chip_smoke.entry_step(batch)
    groups = int(want[4])
    assert int(got[4]) == groups and got[4].dtype == torch.int32
    assert 0 < groups <= 256
    for w, g in zip(want[:4], got[:4]):
        w = np.asarray(w)[:groups]
        assert g.dtype == torch.int32 and w.dtype == np.int32
        np.testing.assert_array_equal(g.numpy()[:groups], w)
