"""Fault-tolerant checkpointing (``repro.ft.checkpoint``): msgpack + zlib
codec, atomic commit, keep-N retention, an async save thread.

Layout (the reference's, so checkpoints cross between the packages in
both directions):

    <dir>/step_<N>/ {tree.msgpack.zst, manifest.json}
    <dir>/step_<N>.COMMITTED        (atomic marker, written last)

The tree file is a msgpack map ``{"a/b/c": {"d": dtype name, "s": shape,
"b": raw bytes} | nil}`` (keys sorted, ``None`` leaves as ``"<key>!none":
nil``), compressed. This module carries its own encoder and decoder for
that msgpack subset, so it needs neither ``msgpack`` nor ``ml_dtypes``:
bf16 leaves are read and written through their raw bytes. It always
writes a zlib frame, which the reference's ``decode_tree`` reads; it
reads zstd frames (what the reference writes where ``zstandard`` is
installed) only when ``zstandard`` imports. Large trees are compressed
on every host core: the stream is cut into chunks, each deflated on its
own thread and ended on a byte boundary (a sync flush), and the chunks
joined under one zlib header and Adler-32 make one ordinary zlib frame.

A tree may hold :class:`repro_torch.dist.sharding.Sharded` leaves (params
and optimizer state placed on a mesh): ``save`` writes each such leaf
whole, gathered from its distinct shards, so a checkpoint has the same
bytes whatever the mesh. Leaves come back as tensors on the CPU, on the
device ``restore(shardings=)`` names, or placed on a mesh by a placement
tree (``sharding.param_shardings``) of any mesh shape: the elastic
restore.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.dist import sharding as SH

_FLAG = "COMMITTED"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_CHUNK = 16 << 20            # bytes of msgpack per deflate worker task


# --------------------------------------------------------------------------
# dtypes by numpy name
# --------------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    """The numpy name of a torch or numpy dtype ("bfloat16", "float32")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"checkpoint leaf of unknown dtype {name!r}")
    return dtype


# --------------------------------------------------------------------------
# The msgpack subset: maps, str, bin, int, int lists, nil
# --------------------------------------------------------------------------

def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                return bytes([code]) + struct.pack(fmt, n)
    for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                           (0xD2, ">i", -0x80000000),
                           (0xD3, ">q", -0x8000000000000000)):
        if n >= low:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _pack_str(s: str) -> bytes:
    b = s.encode()
    n = len(b)
    if n <= 31:
        head = bytes([0xA0 | n])
    elif n <= 0xFF:
        head = bytes([0xD9, n])
    elif n <= 0xFFFF:
        head = b"\xda" + struct.pack(">H", n)
    else:
        head = b"\xdb" + struct.pack(">I", n)
    return head + b


def _pack_bin_head(n: int) -> bytes:
    if n <= 0xFF:
        return bytes([0xC4, n])
    if n <= 0xFFFF:
        return b"\xc5" + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return b"\xc6" + struct.pack(">I", n)
    raise ValueError(f"a leaf of {n} bytes is too large for msgpack")


def _pack_container(n: int, fix: int, code16: int, code32: int) -> bytes:
    if n <= 15:
        return bytes([fix | n])
    if n <= 0xFFFF:
        return bytes([code16]) + struct.pack(">H", n)
    return bytes([code32]) + struct.pack(">I", n)


def _pack_payload(payload: Dict[str, Any]) -> List[Any]:
    """msgpack bytes of ``payload`` as a list of parts (bytes and
    zero-copy memoryviews of the leaves' buffers); their concatenation is
    what ``msgpack.packb(payload, use_bin_type=True)`` gives."""
    parts: List[Any] = [_pack_container(len(payload), 0x80, 0xDE, 0xDF)]
    for key, leaf in payload.items():
        parts.append(_pack_str(key))
        if leaf is None:
            parts.append(b"\xc0")
            continue
        name, shape, buf = leaf
        parts += [b"\x83", _pack_str("d"), _pack_str(name), _pack_str("s"),
                  _pack_container(len(shape), 0x90, 0xDC, 0xDD),
                  b"".join(_pack_int(int(s)) for s in shape),
                  _pack_str("b"), _pack_bin_head(buf.nbytes), buf]
    return parts


class _Reader:
    """Decoder of the msgpack subset over one buffer; bin payloads are
    returned as (offset, length) into it."""

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated checkpoint payload")
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        c = self._take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return bytes(self._take(c & 0x1F)).decode()
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in ints:
            return self._unpack(ints[c])
        if c == 0xC0:
            return None
        width = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
                 0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
                 0xDC: ">H", 0xDD: ">I",                  # array
                 0xDE: ">H", 0xDF: ">I"}                  # map
        if c not in width:
            raise ValueError(f"msgpack type 0x{c:02x} is not in a "
                             "checkpoint's subset")
        n = self._unpack(width[c])
        if c in (0xD9, 0xDA, 0xDB):
            return bytes(self._take(n)).decode()
        if c in (0xC4, 0xC5, 0xC6):
            self._take(n)
            return (self.pos - n, n)
        if c in (0xDC, 0xDD):
            return [self.read() for _ in range(n)]
        return self._map(n)

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


# --------------------------------------------------------------------------
# zlib frames, deflated in parallel
# --------------------------------------------------------------------------

def _chunks(parts, size: int):
    """The concatenation of ``parts`` cut into pieces of ``size`` bytes,
    each as one bytes object; the last one is shorter, possibly empty (it
    carries the stream's final block)."""
    pending, have = [], 0
    for part in parts:
        view = memoryview(part).cast("B")
        while len(view):
            take = min(size - have, len(view))
            pending.append(view[:take])
            have += take
            view = view[take:]
            if have == size:
                yield b"".join(pending)
                pending, have = [], 0
    yield b"".join(pending)


def _zlib_frame(parts, level: int) -> bytes:
    """One zlib frame of the concatenated ``parts``: each chunk deflated on
    its own thread, all but the last ended by a sync flush."""
    chunks = list(_chunks(parts, _CHUNK))

    def deflate(i: int) -> bytes:
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        end = zlib.Z_FINISH if i == len(chunks) - 1 else zlib.Z_SYNC_FLUSH
        return co.compress(chunks[i]) + co.flush(end)

    with ThreadPoolExecutor(max_workers=min(len(chunks),
                                            os.cpu_count() or 1)) as pool:
        bodies = list(pool.map(deflate, range(len(chunks))))
        adler = 1
        for c in chunks:
            adler = zlib.adler32(c, adler)
    return b"".join([zlib.compress(b"", level)[:2], *bodies,
                     struct.pack(">I", adler)])


# --------------------------------------------------------------------------
# Codec: tree <-> bytes
# --------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif tree is None:
        out[prefix[:-1] + "!none"] = None
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        if key.endswith("!none"):
            key, v = key[:-5], None
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _host_leaf(x):
    """A leaf as a host snapshot the caller cannot change later: a CPU
    tensor copy (a sharded leaf gathered whole), or a numpy array copy
    (Python scalars included)."""
    if isinstance(x, SH.Sharded):
        x = x.full("cpu")
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def _leaf_record(x):
    """(dtype name, shape, raw C-order bytes) of a leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        buf = t.reshape(-1).view(torch.uint8).numpy()
        return _dtype_name(t.dtype), list(t.shape), buf
    a = np.asarray(x, order="C")
    return a.dtype.name, list(a.shape), a.reshape(-1).view(np.uint8)


def encode_tree(tree, level: int = 3) -> bytes:
    payload = {k: None if v is None else _leaf_record(v)
               for k, v in _flatten(tree).items()}
    return _zlib_frame(_pack_payload(payload), level)


def _decompress(data: bytes) -> bytes:
    if data[:4] == _ZSTD_MAGIC:
        try:
            import zstandard
        except ImportError:
            raise RuntimeError("checkpoint is zstd-compressed but the "
                               "zstandard module is unavailable") from None
        return zstandard.ZstdDecompressor().decompress(data)
    return zlib.decompress(data)


def decode_tree(data: bytes):
    """The tree of a checkpoint file's bytes, leaves as CPU tensors."""
    raw = _decompress(data)
    payload = _Reader(raw).read()
    flat = {}
    for k, v in payload.items():
        if v is None:
            flat[k] = None
            continue
        off, n = v["b"]
        dtype = _torch_dtype(v["d"])
        if not n:
            flat[k] = torch.empty(v["s"], dtype=dtype)
            continue
        buf = np.frombuffer(raw, np.uint8, count=n, offset=off).copy()
        flat[k] = torch.from_numpy(buf).view(dtype).reshape(v["s"])
    return _unflatten(flat)


def _tree_map2(fn, tree, other):
    """``fn(leaf, other's node)`` over ``tree``'s leaves; ``other`` has
    ``tree``'s structure (a key it lacks is ``None``), or is one node for
    every leaf below."""
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, other.get(k) if isinstance(other, dict)
                              else other) for k, v in tree.items()}
    return fn(tree, other)


# --------------------------------------------------------------------------
# Manager
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = True

    def __post_init__(self):
        self.dir = Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree, *, extra: Optional[Dict] = None,
             block: bool = False):
        """Snapshot to host (a synchronous copy: the port's optimizers
        update params in place), then commit to disk on a background
        thread (training continues during compression/IO)."""
        self.wait()                              # one in-flight save max
        host = _tree_map2(lambda x, _: None if x is None else _host_leaf(x),
                          tree, None)
        extra = dict(extra or {})

        def _write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            (tmp / "tree.msgpack.zst").write_bytes(encode_tree(host))
            (tmp / "manifest.json").write_text(json.dumps(
                {"step": step, "time": time.time(), "extra": extra}))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)               # atomic on POSIX
            (self.dir / f"step_{step}.{_FLAG}").touch()
            self._gc()

        if self.async_save and not block:
            self._thread = threading.Thread(target=self._guard(_write),
                                            daemon=True)
            self._thread.start()
        else:
            _write()

    def _guard(self, fn):
        def wrapped():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 (raised by wait)
                self._error = e
        return wrapped

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {err!r}")

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
            (self.dir / f"step_{s}.{_FLAG}").unlink(missing_ok=True)

    # -- restore ----------------------------------------------------------
    def all_steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1].split(".")[0])
                      for p in self.dir.glob(f"step_*.{_FLAG}"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *,
                shardings=None, target=None):
        """Load a committed checkpoint. ``target`` (a tree of anything
        with ``shape`` and ``dtype``, ``None`` leaves skipped) validates
        shapes and dtypes. ``shardings`` places the leaves: a device puts
        every leaf on it; a tree of ``sharding.Placement`` objects matching
        the stored tree (or a subtree's device) shards each leaf over its
        mesh, whatever mesh saved it. Leaves stay on the CPU without one,
        and where the tree has no entry."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        path = self.dir / f"step_{step}"
        if not (self.dir / f"step_{step}.{_FLAG}").exists():
            raise FileNotFoundError(f"step {step} not committed")
        tree = decode_tree((path / "tree.msgpack.zst").read_bytes())
        manifest = json.loads((path / "manifest.json").read_text())
        if target is not None:
            def chk(p, t):
                if t is not None and p is not None and (
                        tuple(p.shape) != tuple(t.shape)
                        or _dtype_name(p.dtype) != _dtype_name(t.dtype)):
                    raise ValueError(
                        f"checkpoint/target mismatch: {tuple(p.shape)}/"
                        f"{_dtype_name(p.dtype)} vs {tuple(t.shape)}/"
                        f"{_dtype_name(t.dtype)}")
                return p
            tree = _tree_map2(chk, tree, target)
        if shardings is not None:
            def place(x, where):
                if x is None or where is None:
                    return x
                if isinstance(where, SH.Placement):
                    return SH.shard(x, where)
                return x.to(where)
            tree = _tree_map2(place, tree, shardings)
        return tree, manifest
