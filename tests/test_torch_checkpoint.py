"""The port's checkpoint store against the reference's.

Pinned, as ``tests/test_checkpoint.py`` pins them for the reference: save →
restore round-trips values, dtypes and structure (fp32, bf16, fp16, int32,
int8, uint8 and bool leaves, float8 too, in nested dicts, lists and
tuples); metadata rides in the same file; ``latest_step`` ignores ``.tmp``
leftovers and foreign files; ``keep`` prunes; a mismatched template raises
and names the keys; ``step=`` selects the step; artifacts round-trip.  And
the file format is shared: a file the port writes restores through
``repro.checkpoint.store`` with a ``jnp`` template, bf16 included, bitwise,
and the other way round.  Every comparison is bitwise.
"""
import json
import os
import tempfile
import zipfile

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.checkpoint import store as jstore
from repro_torch.checkpoint import store as tstore

DTYPES = ("float32", "bfloat16", "float16", "int32", "int8", "uint8", "bool")
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16, "int32": torch.int32, "int8": torch.int8,
         "uint8": torch.uint8, "bool": torch.bool,
         "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _host(dtype: str, shape, seed: int) -> np.ndarray:
    """Seeded values of ``dtype`` as a numpy array (extension dtypes as
    their ml_dtypes type)."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, size=shape).astype(bool)
    if dtype in ("int32", "int8"):
        return rng.integers(-100, 100, size=shape).astype(dtype)
    if dtype == "uint8":
        return rng.integers(0, 255, size=shape).astype(np.uint8)
    return rng.normal(size=shape).astype(np.float32).astype(
        getattr(ml_dtypes, dtype) if dtype in ("bfloat16", "float8_e4m3fn",
                                               "float8_e5m2") else dtype)


def _torch_leaf(a: np.ndarray, dtype: str) -> torch.Tensor:
    """The same values as a torch tensor (extension dtypes through their
    bits, so no rounding happens on the way)."""
    if dtype in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        bits = np.uint16 if dtype == "bfloat16" else np.uint8
        return torch.from_numpy(a.view(bits).copy()).view(TORCH[dtype])
    return torch.from_numpy(a.copy())


def _bits(t) -> np.ndarray:
    """A leaf's raw bytes as a uint8 array (dtype-blind, bitwise)."""
    if isinstance(t, torch.Tensor):
        t = t.contiguous().reshape(-1)
        return t.view(torch.uint8).numpy() if t.dtype != torch.bool else t.numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(t)).reshape(-1).view(np.uint8)


def _tree(dt_a, dt_b, dt_c, rows, seed, maker):
    return {
        "state": {"weights": maker(dt_a, (rows, 3), seed),
                  "moment": maker(dt_b, (rows,), seed + 1)},
        "counters": (maker(dt_c, (2, 2), seed + 2), maker("int32", (), seed + 3)),
        "hist": [maker(dt_a, (1,), seed + 4)],
        "absent": None,
    }


def _torch_tree(dt_a, dt_b, dt_c, rows, seed):
    return _tree(dt_a, dt_b, dt_c, rows, seed,
                 lambda d, s, k: _torch_leaf(_host(d, s, k), d))


def _jax_tree(dt_a, dt_b, dt_c, rows, seed):
    return _tree(dt_a, dt_b, dt_c, rows, seed,
                 lambda d, s, k: jnp.asarray(_host(d, s, k)))


def _leaves(tree):
    return [v for _, v in tstore._leaves_with_keys(tree)]


def _assert_same(got, want):
    """Same structure, dtypes and bits (torch or jax leaves)."""
    assert [k for k, _ in tstore._leaves_with_keys(got)] == \
        [k for k, _ in tstore._leaves_with_keys(want)]
    assert type(got["counters"]) is type(want["counters"])
    for g, w in zip(_leaves(got), _leaves(want)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype).replace("torch.", "")
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(_bits(g), _bits(w))


# --------------------------------------------------------------------------- #
# the port's store on its own
# --------------------------------------------------------------------------- #
@settings(max_examples=20, deadline=None)
@given(dt_a=st.sampled_from(DTYPES), dt_b=st.sampled_from(DTYPES),
       dt_c=st.sampled_from(DTYPES), rows=st.integers(1, 16),
       step=st.integers(0, 10**6), seed=st.integers(0, 2**16))
def test_roundtrip_preserves_values_dtypes_structure(dt_a, dt_b, dt_c, rows,
                                                     step, seed):
    tree = _torch_tree(dt_a, dt_b, dt_c, rows, seed)
    with tempfile.TemporaryDirectory() as d:
        tstore.save_checkpoint(d, step, tree)
        restored, got_step = tstore.restore_checkpoint(d, tree, device="cpu")
    assert got_step == step
    _assert_same(restored, tree)


@pytest.mark.parametrize("dtype", DTYPES + ("float8_e4m3fn", "float8_e5m2"))
def test_each_dtype_round_trips_bitwise(tmp_path, dtype):
    leaf = _torch_leaf(_host(dtype, (3, 5), 7), dtype)
    tstore.save_checkpoint(str(tmp_path), 1, {"w": leaf})
    got, _ = tstore.restore_checkpoint(str(tmp_path), {"w": 0},
                                       device="cpu")
    assert got["w"].dtype == TORCH[dtype]
    np.testing.assert_array_equal(_bits(got["w"]), _bits(leaf))


@settings(max_examples=15, deadline=None)
@given(epoch=st.integers(0, 1000), stream_step=st.integers(0, 10**6),
       rng_hi=st.integers(0, 2**31 - 1))
def test_metadata_roundtrips_in_same_file(epoch, stream_step, rng_hi):
    meta = {"epoch": epoch, "stream_step": stream_step, "rng": [rng_hi, 7],
            "schedule": "allreduce"}
    with tempfile.TemporaryDirectory() as d:
        tstore.save_checkpoint(d, epoch, {"w": torch.arange(4.0)}, metadata=meta)
        _, step, got = tstore.restore_with_metadata(d, {"w": 0}, device="cpu")
        assert step == epoch and got == meta and tstore.load_metadata(d) == meta


@settings(max_examples=20, deadline=None)
@given(steps=st.lists(st.integers(0, 500), min_size=1, max_size=6),
       junk_step=st.integers(501, 999))
def test_latest_step_ignores_tmp_and_foreign_files(steps, junk_step):
    with tempfile.TemporaryDirectory() as d:
        for s in steps:
            tstore.save_checkpoint(d, s, {"w": torch.zeros(2)})
        for junk in (f"step_{junk_step}.npz.tmp", "notes.txt", "xstep_7777.npz",
                     "step_.npz", f"step_{junk_step}.npz.{os.getpid()}.tmp"):
            open(os.path.join(d, junk), "wb").close()
        assert tstore.latest_step(d) == max(steps)
        assert tstore.restore_checkpoint(d, {"w": 0}, device="cpu")[1] == max(steps)


def test_latest_step_empty_and_missing(tmp_path):
    assert tstore.latest_step(str(tmp_path)) is None
    assert tstore.latest_step(str(tmp_path / "nope")) is None
    with pytest.raises(FileNotFoundError):
        tstore.restore_checkpoint(str(tmp_path), {"w": 0}, device="cpu")


def test_keep_prunes_all_but_newest(tmp_path):
    for s in range(1, 6):
        tstore.save_checkpoint(str(tmp_path), s, {"w": torch.zeros(2)}, keep=2)
    open(tmp_path / "step_9.npz.123.tmp", "wb").close()   # left alone
    tstore.prune_checkpoints(str(tmp_path), 2)
    assert sorted(os.listdir(tmp_path)) == ["step_4.npz", "step_5.npz",
                                            "step_9.npz.123.tmp"]
    with pytest.raises(ValueError):
        tstore.prune_checkpoints(str(tmp_path), 0)


def test_mismatched_template_raises_and_names_the_keys(tmp_path):
    tstore.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3), "b": torch.zeros(1)})
    with pytest.raises(ValueError) as t_err:
        tstore.restore_checkpoint(str(tmp_path), {"w": 0, "extra_moment": 0},
                                  device="cpu")
    assert "extra_moment" in str(t_err.value) and "'b'" in str(t_err.value)
    # the reference raises the same error on the same file
    with pytest.raises(ValueError) as j_err:
        jstore.restore_checkpoint(str(tmp_path), {"w": jnp.zeros(3),
                                                  "extra_moment": jnp.zeros(3)})
    assert str(t_err.value) == str(j_err.value)


def test_leaves_that_flatten_to_one_key_raise(tmp_path):
    with pytest.raises(ValueError, match="same key 'a/b'"):
        tstore.save_checkpoint(str(tmp_path), 0, {"a/b": torch.zeros(1),
                                                  "a": {"b": torch.ones(1)}})
    with pytest.raises(ValueError, match="reserved"):
        tstore.save_checkpoint(str(tmp_path), 0, {"__checkpoint_meta__": torch.zeros(1)})
    assert tstore.latest_step(str(tmp_path)) is None


def test_restore_selects_requested_step(tmp_path):
    for s in (1, 2, 3):
        tstore.save_checkpoint(str(tmp_path), s, {"w": torch.full((2,), float(s))})
    restored, step = tstore.restore_checkpoint(str(tmp_path), {"w": 0}, step=2,
                                               device="cpu")
    assert step == 2 and restored["w"].tolist() == [2.0, 2.0]


def test_artifacts_round_trip(tmp_path):
    tree = _torch_tree("bfloat16", "float32", "int8", 4, 3)
    meta = {"pipeline": {"stages": [["ngrams", {"kind": "ngrams"}]], "num_cols": 5}}
    path = tstore.save_artifact(str(tmp_path), tree, metadata=meta)
    assert os.path.basename(path) == f"step_{tstore.ARTIFACT_STEP}.npz"
    got, got_meta = tstore.load_artifact(str(tmp_path), tree, device="cpu")
    _assert_same(got, tree)
    assert got_meta == meta


def test_atomic_writes_leave_no_partial(tmp_path):
    path = str(tmp_path / "sub" / "result.json")
    tstore.atomic_write_json(path, {"a": 1})
    tstore.atomic_write_text(path, "replaced\n")
    assert open(path).read() == "replaced\n"
    assert os.listdir(tmp_path / "sub") == ["result.json"]


def test_a_dtype_torch_lacks_raises(tmp_path):
    """A record naming a dtype that neither numpy nor the port's raw-bit
    table knows raises instead of restoring something else."""
    arrays = {"w": np.zeros(3, np.uint8),
              "__checkpoint_meta__": np.array(json.dumps(
                  {"step": 0, "dtypes": {"w": "float8_e4m3fnuz"}, "metadata": None}))}
    with open(tmp_path / "step_0.npz", "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(ValueError, match="float8_e4m3fnuz"):
        tstore.restore_checkpoint(str(tmp_path), {"w": 0}, device="cpu")


# --------------------------------------------------------------------------- #
# the file format is the reference's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dts", [("float32", "bfloat16", "int8"),
                                 ("bfloat16", "float16", "bool"),
                                 ("uint8", "int32", "bfloat16")])
def test_a_port_file_restores_in_the_reference_bitwise(tmp_path, dts):
    tree = _torch_tree(*dts, rows=5, seed=11)
    meta = {"epoch": 3, "rng": [1, 2]}
    tstore.save_checkpoint(str(tmp_path), 3, tree, metadata=meta)
    template = _jax_tree(*dts, rows=5, seed=0)
    template.pop("absent")
    got, step, got_meta = jstore.restore_with_metadata(str(tmp_path), template)
    assert step == 3 and got_meta == meta
    want = _jax_tree(*dts, rows=5, seed=11)
    want.pop("absent")
    got["absent"] = want["absent"] = None
    _assert_same(got, want)


@pytest.mark.parametrize("dts", [("float32", "bfloat16", "int8"),
                                 ("bfloat16", "float16", "bool"),
                                 ("uint8", "int32", "bfloat16")])
def test_a_reference_file_restores_in_the_port_bitwise(tmp_path, dts):
    tree = _jax_tree(*dts, rows=5, seed=12)
    tree.pop("absent")
    jstore.save_checkpoint(str(tmp_path), 7, tree, metadata={"epoch": 7})
    got, step, meta = tstore.restore_with_metadata(str(tmp_path), tree, device="cpu")
    assert step == 7 and meta == {"epoch": 7}
    want = _torch_tree(*dts, rows=5, seed=12)
    want.pop("absent")
    got["absent"] = want["absent"] = None
    _assert_same(got, want)
    assert all(isinstance(v, torch.Tensor) for v in _leaves(got))


def test_both_packages_write_the_same_members(tmp_path):
    """Member names and order, each member's array bytes, and the JSON
    record are the same whichever package writes the file."""
    tstore.save_checkpoint(str(tmp_path / "t"), 2, _torch_tree("bfloat16", "float32", "bool", 3, 5),
                           metadata={"epoch": 2})
    jt = _jax_tree("bfloat16", "float32", "bool", 3, 5)
    jstore.save_checkpoint(str(tmp_path / "j"), 2, jt, metadata={"epoch": 2})
    zt = zipfile.ZipFile(tmp_path / "t" / "step_2.npz")
    zj = zipfile.ZipFile(tmp_path / "j" / "step_2.npz")
    assert zt.namelist() == zj.namelist()
    with np.load(tmp_path / "t" / "step_2.npz") as ft, \
            np.load(tmp_path / "j" / "step_2.npz") as fj:
        for k in ft.files:
            assert ft[k].dtype.itemsize == fj[k].dtype.itemsize, k
            if k == "__checkpoint_meta__":
                assert json.loads(str(ft[k][()])) == json.loads(str(fj[k][()]))
            else:
                np.testing.assert_array_equal(_bits(ft[k]), _bits(fj[k]))
