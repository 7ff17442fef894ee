"""Checkpoints: atomic, asynchronous, keep-N, in the reference's format.

Counterpart of ``repro/checkpoint/manager.py``, byte for byte on disk:

* **Format.**  ``step_XXXXXXXXXX/leaf_%05d.npy`` holds one leaf's raw
  bytes as a flat ``uint8`` array; ``manifest.json`` lists each leaf's
  ``shape``, ``dtype`` (the numpy name: ``"float32"``, ``"bfloat16"``, ...)
  and ``sha`` (sha256[:16] of its bytes), with ``extra`` beside them.
  Leaves are numbered as ``jax.tree.flatten`` numbers them: dict keys
  sorted, lists and tuples in order, a QTensor's children as (payload,
  scales, scale32).  So the reference restores what the port writes and
  the other way round, and a packed tree's ``pytree_spec`` (the manifest's
  JSON structure, :func:`qtensor.tree_spec`) rebuilds it with no template.
* **Atomic.**  A step is written to ``step_XXXX.tmp/`` and renamed once its
  ``manifest.json``, written last, is in place; ``latest_step`` ignores
  ``.tmp`` directories and directories without a manifest.
* **Asynchronous.**  ``save`` copies every leaf to host memory first, then
  one thread writes them (``wait`` joins it); one save is in flight at a
  time.  A ``blocking`` save writes CPU leaves from their own memory.
  Each leaf is hashed once: a packed array's digests are its leaves'.
* **Keep-N.**  After a save the oldest steps past ``keep`` are removed.

Leaves are torch tensors on any device; ``restore`` returns CPU tensors,
bf16 and float8 leaves reinterpreted from their bytes (numpy has no such
dtypes of its own).  Not ported: ``shardings=`` (ROADMAP §1 item 7), and
the serving engine's retries of a checkpoint read behind its fault
boundary (§1 item 4).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.core import qtensor

__all__ = ["CheckpointManager", "damage_packed_array", "packed_checksums",
           "verify_packed_tree"]

# The format bit of a block rides in the SIGN of its E4M3 scale byte, so a
# corrupt scale byte flips a block between E2M1 and E1M2: integrity is
# checked per array.  0x80 (negative-zero E4M3) is never written by the
# packers (a zero-magnitude scale carries no type bit), so it proves
# corruption even where the digests of the corrupt bytes verify; the
# reference rejects it.  The port also rejects a 0x7F/0xFF byte (E4M3 NaN),
# which the packers never write either: on it the expert decode kernel,
# which skips a split whose activations are all zero, would give +0 where
# the reference's product gives NaN (csrc/mixfp4_gemm_experts.cuh).
_NEG_ZERO_E4M3 = 0x80
_NAN_E4M3 = 0x7F

# numpy names of the dtypes numpy itself cannot hold
_TORCH_DTYPES = {"bfloat16": torch.bfloat16,
                 "float8_e4m3fn": torch.float8_e4m3fn,
                 "float8_e5m2": torch.float8_e5m2}


def _torch_dtype(name: str) -> torch.dtype:
    dtype = _TORCH_DTYPES.get(name) or getattr(torch, np.dtype(name).name,
                                                None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"checkpoint leaf dtype {name!r} has no torch "
                         "counterpart")
    return dtype


def _host_bytes(leaf: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a flat uint8 array on the host (a view where the
    tensor is already a contiguous CPU tensor)."""
    t = leaf.detach().contiguous().cpu().reshape(-1)
    return t.view(torch.uint8).numpy() if t.numel() else np.zeros(0, np.uint8)


def _snapshot(leaf: torch.Tensor, copy: bool) -> tuple[np.ndarray, list,
                                                       str]:
    """(bytes, shape, dtype name) of a tensor in host memory: a device
    tensor is copied anyway, a CPU one only with ``copy`` (a background
    write, while the caller may write the tensor)."""
    raw = _host_bytes(leaf)
    if copy and leaf.device.type == "cpu":
        raw = raw.copy()
    return raw, list(leaf.shape), qtensor._dtype_name(leaf.dtype)


def _sha16(data) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Trees: the order jax.tree.flatten gives
# ---------------------------------------------------------------------------
def _flatten(tree) -> tuple[list, object]:
    """(leaves, structure): dict keys sorted, lists and tuples in order, a
    QTensor's (payload, scales, scale32)."""
    leaves: list = []

    def walk(node):
        if isinstance(node, qtensor.QTensor):
            leaves.extend((node.payload, node.scales, node.scale32))
            return ("q", node)
        if isinstance(node, dict):
            return ("d", [(k, walk(node[k])) for k in sorted(node)],
                    list(node))
        if isinstance(node, (list, tuple)):
            return ("l", [walk(v) for v in node], type(node))
        leaves.append(node)
        return ("x",)

    return leaves, walk(tree)


def _unflatten(structure, leaves: list):
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "q":
            payload, scales, scale32 = next(it), next(it), next(it)
            return node[1].replace(payload=payload, scales=scales,
                                   scale32=scale32)
        if kind == "d":
            built = {k: build(v) for k, v in node[1]}
            return {k: built[k] for k in node[2]}
        if kind == "l":
            return node[2](build(v) for v in node[1])
        return next(it)

    return build(structure)


def _named_qtensors(tree):
    """('a/b/c', QTensor) for every QTensor of a tree of nested dicts and
    lists, in the reference's order and with its names."""
    def walk(node, path):
        if isinstance(node, qtensor.QTensor):
            yield "/".join(path) or "<root>", node
        elif isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for j, v in enumerate(node):
                yield from walk(v, path + [str(j)])
    yield from walk(tree, [])


# ---------------------------------------------------------------------------
# Packed-tree integrity
# ---------------------------------------------------------------------------
def packed_checksums(tree) -> dict:
    """Per-array digests ``{'path': {'payload': sha16, 'scales': sha16,
    'scale32': sha16}}`` over every QTensor in ``tree``."""
    return {name: {"payload": _sha16(_host_bytes(qt.payload)),
                   "scales": _sha16(_host_bytes(qt.scales)),
                   "scale32": _sha16(_host_bytes(qt.scale32))}
            for name, qt in _named_qtensors(tree)}


def verify_packed_tree(tree, checksums: dict | None = None):
    """Validate a restored packed tree.

    * Every scale plane is scanned for the non-canonical 0x80 byte (raises
      ``ValueError`` naming the array, with the reference's message) and
      for the E4M3 NaN bytes 0x7F / 0xFF (``ValueError`` in the same form;
      the reference accepts them).
    * With per-array ``checksums`` (from a ``save_packed`` manifest), each
      array's digests are recomputed and compared: ``IOError`` naming the
      first array and plane that differ.  Arrays absent from
      ``checksums`` are skipped."""
    for name, qt in _named_qtensors(tree):
        scales = qt.scales
        if scales.dtype == torch.uint8:
            if bool((scales == _NEG_ZERO_E4M3).any()):
                raise ValueError(
                    f"corrupt scale plane in packed array {name!r}: contains "
                    f"the non-canonical 0x80 negative-zero E4M3 byte (the "
                    "MixFP4 packers never emit it — a zero-magnitude scale "
                    "byte never carries the type-in-sign format bit), so the "
                    "block would misdecode as the wrong micro-format")
            if bool(((scales & 0x7F) == _NAN_E4M3).any()):
                raise ValueError(
                    f"corrupt scale plane in packed array {name!r}: contains "
                    f"the E4M3 NaN scale byte 0x7F/0xFF (the MixFP4 packers "
                    "never emit it: the largest block scale is 448, 0x7E), "
                    "so the block would decode to NaN")
        if checksums is None:
            continue
        want = checksums.get(name)
        if want is None:
            continue                # array added after the checkpoint was cut
        got = {"payload": _sha16(_host_bytes(qt.payload)),
               "scales": _sha16(_host_bytes(qt.scales))}
        if "scale32" in want:
            got["scale32"] = _sha16(_host_bytes(qt.scale32))
        for plane, digest in got.items():
            if want.get(plane, digest) != digest:
                raise IOError(
                    f"packed checksum mismatch on array {name!r} "
                    f"({plane} plane): manifest {want[plane]} != "
                    f"restored {digest}")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _steps(self) -> list[int]:
        """Complete steps: ``step_*`` directories, not ``.tmp``, with a
        manifest."""
        return sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.dir, n, "manifest.json")))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, *, extra: dict | None = None,
             blocking: bool = False):
        """Snapshot every leaf to host memory, then write them (in a
        background thread unless ``blocking``)."""
        self._save(step, tree, lambda shas: extra or {}, blocking)

    def _save(self, step: int, tree, extra_of, blocking: bool):
        """``save`` with the manifest's ``extra`` built from the leaves'
        shas (``extra_of(shas)``), so no leaf is hashed twice."""
        leaves, _ = _flatten(tree)
        host = [_snapshot(x, copy=not blocking) for x in leaves]
        del leaves
        self.wait()  # only one in-flight save

        def write():
            tmp = self._step_dir(step) + ".tmp"
            final = self._step_dir(step)
            os.makedirs(tmp, exist_ok=True)
            shas = []
            for i, (raw, _, _) in enumerate(host):
                np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), raw)
                shas.append(_sha16(raw))
            manifest = {"step": step, "extra": extra_of(shas),
                        "leaves": [{"i": i, "shape": shape, "dtype": dtype,
                                    "sha": sha}
                                   for i, ((_, shape, dtype), sha)
                                   in enumerate(zip(host, shas))]}
            # manifest last => atomicity marker
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None

    def _gc(self):
        for s in self._steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: int, like_tree, *, shardings=None,
                verify: bool = True):
        """Load ``step`` into the structure of ``like_tree`` (its leaves are
        placeholders: only the structure is read) as CPU tensors.  Returns
        (tree, extra).  A leaf whose bytes do not match its manifest sha
        raises ``IOError``."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...) places leaves on a device mesh, "
                "which is not ported yet (ROADMAP §1 item 7, multi-GPU)")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, structure = _flatten(like_tree)
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError(f"checkpoint has {len(manifest['leaves'])} "
                             f"leaves, tree {len(leaves)}")
        out = []
        for i, meta in enumerate(manifest["leaves"]):
            raw = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
            if verify and _sha16(raw) != meta["sha"]:
                raise IOError(f"checksum mismatch on leaf {i} @ step {step}")
            t = torch.from_numpy(raw).view(_torch_dtype(meta["dtype"]))
            out.append(t.reshape(meta["shape"]))
        return _unflatten(structure, out), manifest["extra"]

    def restore_latest(self, like_tree, **kw):
        step = self.latest_step()
        if step is None:
            return None, None, None
        tree, extra = self.restore(step, like_tree, **kw)
        return step, tree, extra

    # ------------------------------------------------------------------
    # Packed-weight checkpoints: the tree's structure (QTensor metadata,
    # dict nesting) goes into the manifest as a JSON spec, so
    # ``restore_packed`` rebuilds the QTensor tree with no template.
    # ------------------------------------------------------------------
    def save_packed(self, step: int, tree, *, extra: dict | None = None,
                    blocking: bool = True):
        extra = dict(extra or {})
        extra["pytree_spec"] = qtensor.tree_spec(tree)
        # an array's digests are its leaves' shas: hashed once, in write
        index = {id(x): i for i, x in enumerate(_flatten(tree)[0])}
        planes = {name: {p: index[id(getattr(qt, p))]
                         for p in ("payload", "scales", "scale32")}
                  for name, qt in _named_qtensors(tree)}

        def extra_of(shas):
            return {**extra, "packed_checksums": {
                name: {p: shas[i] for p, i in leaf.items()}
                for name, leaf in planes.items()}}

        self._save(step, tree, extra_of, blocking)

    def packed_spec(self, step: int | None = None) -> tuple[int, dict]:
        """(step, JSON tree spec) of a packed checkpoint, from its manifest
        alone."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            spec = json.load(f)["extra"].get("pytree_spec")
        if spec is None:
            raise ValueError(f"step {step} was not written by save_packed "
                             "(no pytree_spec in manifest)")
        return step, spec

    def packed_fingerprint(self, step: int | None = None) -> str:
        """Content fingerprint of a packed checkpoint: sha256[:16] over the
        manifest's per-array ``packed_checksums`` (canonical JSON), or over
        the per-leaf shas of a manifest without them."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            manifest = json.load(f)
        basis = manifest["extra"].get("packed_checksums") \
            or [leaf["sha"] for leaf in manifest["leaves"]]
        return _sha16(json.dumps(basis, sort_keys=True).encode())

    def restore_packed(self, step: int | None = None, *,
                       verify_packed: bool = True, **kw):
        """Restore a packed QTensor tree (CPU tensors) from the manifest's
        spec alone.  ``verify_packed`` (default on) recomputes each array's
        digests against the manifest's ``packed_checksums`` and scans every
        scale plane (:func:`verify_packed_tree`)."""
        step, spec = self.packed_spec(step)
        tree, extra = self.restore(step, qtensor.tree_like(spec), **kw)
        extra.pop("pytree_spec", None)
        checksums = extra.pop("packed_checksums", None)
        if verify_packed:
            verify_packed_tree(tree, checksums)
        return tree, extra


def _replace(path: str, write) -> None:
    """Write ``path`` anew through ``write(file)``: a new file renamed over
    the old one, so other links to the old file keep its bytes."""
    with open(path + ".new", "wb") as f:
        write(f)
    os.replace(path + ".new", path)


def damage_packed_array(directory: str, array: str, plane: str, mutate, *,
                        fix_packed: bool, step: int | None = None) -> int:
    """Fault injection: apply ``mutate(flat uint8) -> flat uint8`` to the
    ``plane`` leaf (``"payload"``, ``"scales"`` or ``"scale32"``) of packed
    array ``array`` (``"layers/attn/wq"``, say) in a ``save_packed``
    checkpoint (the latest step by default), and fix up the leaf's sha, as
    if the bytes were damaged before the checksums were taken.
    ``fix_packed`` also fixes up the array's digest, so only the scale scan
    can catch the damage.  Files are replaced, not written in place, so a
    copy that hard-links the original's files leaves the original intact.
    Returns the leaf's new first byte."""
    ckpt = CheckpointManager(directory)
    step, spec = ckpt.packed_spec(step)
    step_dir = ckpt._step_dir(step)
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    like = qtensor.tree_like(spec)
    target = getattr(dict(_named_qtensors(like))[array], plane)
    i = next(j for j, leaf in enumerate(_flatten(like)[0])
             if leaf is target)
    path = os.path.join(step_dir, f"leaf_{i:05d}.npy")
    raw = mutate(np.load(path).copy())
    _replace(path, lambda f: np.save(f, raw))
    digest = _sha16(raw)
    manifest["leaves"][i]["sha"] = digest
    if fix_packed:
        manifest["extra"]["packed_checksums"][array][plane] = digest
    _replace(os.path.join(step_dir, "manifest.json"),
             lambda f: f.write(json.dumps(manifest).encode()))
    return int(raw[0])
