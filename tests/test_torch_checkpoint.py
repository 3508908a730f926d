"""The port's checkpoints against the reference's: a tree written by
either package restores in the other with every leaf byte-equal (bf16,
f32, int32, int8, bool, 0-d, empty, ``None``), the port's msgpack subset
is byte-equal to ``msgpack.packb``, its parallel zlib frame is one
ordinary zlib stream, and the manager's ``keep``/``COMMITTED``/
``target``/async behaviour matches the reference's."""
import json
import sys
import zlib

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.ft import checkpoint as J
from repro_torch.ft import checkpoint as T


def ref_tree(seed=0):
    """The reference's kind of tree: numpy leaves (bf16 from ml_dtypes)."""
    rng = np.random.default_rng(seed)
    return {"params": {
        "layers": {"w": np.asarray(jnp.asarray(
            rng.standard_normal((3, 5, 4)), jnp.bfloat16)),
            "scale": rng.standard_normal((3, 4)).astype(np.float32)},
        "embed": {"table": rng.standard_normal((7, 4)).astype(np.float32)}},
        "opt": {"step": np.asarray(5, np.int32),
                "q": rng.integers(-127, 128, (6,)).astype(np.int8),
                "mask": rng.random(5) > 0.5,
                "empty": np.zeros((0, 3), np.float32)},
        "none_leaf": None}


def bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def name(x) -> str:
    return T._dtype_name(x.dtype)


def assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            assert_trees_equal(got[k], want[k])
        return
    if want is None:
        assert got is None
        return
    assert name(got) == name(want)
    assert tuple(got.shape) == tuple(want.shape)
    assert bits(got) == bits(want)


def port_tree(seed=0):
    return T.decode_tree(J.encode_tree(ref_tree(seed)))


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_frame_decodes_in_the_port(seed):
    """zstd where ``zstandard`` is installed (this frame's magic), else
    zlib: both decode to tensors byte-equal to the numpy leaves."""
    got = T.decode_tree(J.encode_tree(ref_tree(seed)))
    assert_trees_equal(got, ref_tree(seed))
    assert got["params"]["layers"]["w"].dtype == torch.bfloat16
    assert got["opt"]["step"].shape == ()


def test_reference_zlib_frame_decodes_in_the_port(monkeypatch):
    monkeypatch.setattr(J, "zstandard", None)
    monkeypatch.setattr(J, "zlib", zlib, raising=False)
    data = J.encode_tree(ref_tree())
    assert data[:4] != T._ZSTD_MAGIC
    assert_trees_equal(T.decode_tree(data), ref_tree())


@pytest.mark.parametrize("chunk", [T._CHUNK, 1000, 4096])
def test_port_frame_decodes_in_the_reference(monkeypatch, chunk):
    """Chunks deflated apart still make one zlib stream."""
    monkeypatch.setattr(T, "_CHUNK", chunk)
    tree = port_tree()
    data = T.encode_tree(tree)
    assert zlib.decompress(data)            # one ordinary zlib frame
    got = J.decode_tree(data)
    assert got["params"]["layers"]["w"].dtype == jnp.bfloat16
    assert_trees_equal(tree, got)
    assert_trees_equal(T.decode_tree(data), got)


def test_msgpack_subset_equals_packb():
    tree = port_tree()
    flat = T._flatten(tree)
    payload = {k: None if v is None else T._leaf_record(v)
               for k, v in flat.items()}
    ours = b"".join(bytes(memoryview(p).cast("B"))
                    for p in T._pack_payload(payload))
    theirs = msgpack.packb({k: None if v is None else
                            {"d": v[0], "s": v[1], "b": v[2].tobytes()}
                            for k, v in payload.items()}, use_bin_type=True)
    assert ours == theirs
    assert T._Reader(theirs).read().keys() == payload.keys()


@pytest.mark.parametrize("n", [0, 1, 127, 128, 255, 256, 65535, 65536,
                               2**32 - 1, 2**32, -1, -32, -33, -128, -129,
                               -32768, -32769, -2**31, -2**31 - 1])
def test_msgpack_ints_equal_packb(n):
    assert T._pack_int(n) == msgpack.packb(n)
    assert T._Reader(msgpack.packb(n)).read() == n


@pytest.mark.parametrize("size", [0, 31, 32, 255, 256, 70000])
def test_msgpack_str_bin_and_lists_equal_packb(size):
    s = "k" * size
    assert T._pack_str(s) == msgpack.packb(s, use_bin_type=True)
    b = bytes(range(256)) * (size // 256 + 1)
    b = b[:size]
    assert T._pack_bin_head(size) + b == msgpack.packb(b, use_bin_type=True)
    lst = list(range(size % 40))
    packed = T._pack_container(len(lst), 0x90, 0xDC, 0xDD) + b"".join(
        T._pack_int(i) for i in lst)
    assert packed == msgpack.packb(lst)
    assert T._Reader(packed).read() == lst


def test_zstd_frame_without_zstandard_raises_the_reference_error(
        monkeypatch):
    data = J.encode_tree(ref_tree())
    if data[:4] != T._ZSTD_MAGIC:
        pytest.skip("the reference writes zlib here (no zstandard)")
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstandard module is "
                                           "unavailable"):
        T.decode_tree(data)


# --------------------------------------------------------------------------
# The manager
# --------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_directories_cross_between_packages(tmp_path, writer):
    extra = {"pipe": {"doc_cursor": 3, "buf": [1, 2, 3], "step": 2},
             "step": 7}
    if writer == "port":
        T.CheckpointManager(str(tmp_path), async_save=False).save(
            7, port_tree(), extra=extra)
        got, manifest = J.CheckpointManager(str(tmp_path)).restore()
        assert_trees_equal(port_tree(), got)
    else:
        J.CheckpointManager(str(tmp_path), async_save=False).save(
            7, ref_tree(), extra=extra)
        got, manifest = T.CheckpointManager(str(tmp_path)).restore()
        assert_trees_equal(got, ref_tree())
    assert manifest["step"] == 7 and manifest["extra"] == extra
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_7", "step_7.COMMITTED"]
    assert sorted(p.name for p in (tmp_path / "step_7").iterdir()) == [
        "manifest.json", "tree.msgpack.zst"]


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_keep_and_latest_like_the_reference(tmp_path, keep):
    for mod, d in ((T, tmp_path / "t"), (J, tmp_path / "j")):
        m = mod.CheckpointManager(str(d), keep=keep, async_save=False)
        for s in (1, 2, 3, 4):
            m.save(s, {"w": np.ones(2, np.float32)})
    assert T.CheckpointManager(str(tmp_path / "t")).all_steps() \
        == J.CheckpointManager(str(tmp_path / "j")).all_steps() \
        == [1, 2, 3, 4][-keep:]
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) \
        == sorted(p.name for p in (tmp_path / "j").iterdir())


def test_uncommitted_step_is_ignored(tmp_path):
    m = T.CheckpointManager(str(tmp_path), async_save=False)
    m.save(1, {"w": torch.ones(2)})
    m.save(2, {"w": torch.zeros(2)})
    (tmp_path / "step_2.COMMITTED").unlink()            # a crash
    assert m.latest_step() == 1
    assert J.CheckpointManager(str(tmp_path)).latest_step() == 1
    got, manifest = m.restore()
    assert manifest["step"] == 1 and torch.equal(got["w"], torch.ones(2))
    with pytest.raises(FileNotFoundError):
        m.restore(2)
    with pytest.raises(FileNotFoundError):
        T.CheckpointManager(str(tmp_path / "empty")).restore()


def test_restore_validates_target(tmp_path):
    m = T.CheckpointManager(str(tmp_path), async_save=False)
    m.save(1, {"w": torch.ones((2, 2)), "b": torch.zeros(3,
                                                         dtype=torch.int32)})
    m.restore(target={"w": torch.empty((2, 2)), "b": None})
    m.restore(target={"w": np.empty((2, 2), np.float32),
                      "b": np.empty(3, np.int32)})
    with pytest.raises(ValueError):
        m.restore(target={"w": torch.empty((3, 3)), "b": None})
    with pytest.raises(ValueError):
        m.restore(target={"w": torch.empty((2, 2), dtype=torch.bfloat16),
                          "b": None})


def test_restore_places_leaves_on_a_device(tmp_path):
    m = T.CheckpointManager(str(tmp_path), async_save=False)
    m.save(1, port_tree())
    got, _ = m.restore(shardings="cpu")
    assert got["params"]["embed"]["table"].device == torch.device("cpu")
    got, _ = m.restore(shardings=torch.device("cpu"))
    assert_trees_equal(got, port_tree())


def test_async_save_snapshots_before_returning(tmp_path):
    """The port's optimizers update params in place: a save must keep the
    values it was given, whatever happens to the tensors after."""
    m = T.CheckpointManager(str(tmp_path))
    w = torch.arange(6, dtype=torch.float32)
    m.save(5, {"w": w})
    w.add_(100.0)
    m.wait()
    assert m.latest_step() == 5
    got, _ = m.restore()
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))


def test_async_failure_surfaces_in_wait(tmp_path):
    m = T.CheckpointManager(str(tmp_path))
    m.save(1, {"w": torch.ones(2)}, extra={"bad": object()})
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        m.wait()
    assert m.latest_step() is None


def test_manifest_json_is_the_reference_schema(tmp_path):
    T.CheckpointManager(str(tmp_path), async_save=False).save(
        4, {"w": torch.ones(1)}, extra={"a": 1})
    manifest = json.loads((tmp_path / "step_4" / "manifest.json")
                          .read_text())
    assert sorted(manifest) == ["extra", "step", "time"]
