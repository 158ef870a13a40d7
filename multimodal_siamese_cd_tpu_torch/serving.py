"""Serving bundles: exported eval-mode forwards and the weights in one file
(the JAX package's ``serving.py``).

A trained model is exported ahead of time with :func:`torch.export.export`,
one artifact per (platform, batch, padded scene-size bucket), the same
static-shape strategy as the evaluation stack, and bundled with its
weights::

    bundle.zip
      meta.json            buckets, batch sizes, weight dtype and its bf16
                           leaves, model type, input mode, in_channels,
                           torch version, platforms, compute dtype per
                           platform
      variables.npz        the model's state_dict leaves in order, once
                           (bf16 leaves stored as uint16 views)
      {platform}/fwd_{h}x{w}.pt2        batch 1: (leaves, x1, x2) -> probs
      {platform}/fwd_b{b}_{h}x{w}.pt2   batch b > 1

The exported forward takes the weights as a flat, ordered list of graph
inputs (``torch.func.functional_call``), so no artifact carries a copy of
them, and NCHW float32 scenes ``(b, C, h, w)``; it returns ``(b, 1, h, w)``
float32 probabilities: :func:`.train_lib.probabilities`, the arithmetic of
``eval_forward`` (the first head, then a sigmoid; bf16 autocast in a
``cuda`` artifact when the model computes in bf16, fp32 in a ``cpu`` one).
Loading a bundle needs torch and numpy only, none of the port's model,
config or training code.

Platforms are ``cuda`` (alias ``gpu``) and ``cpu``, each with artifacts of
its own; a ``cuda`` bundle never runs on the CPU, and exporting for
``cuda`` needs the card. ``weights_dtype='bf16'`` stores float32 leaves
rounded to bfloat16 (half the bundle); they are widened back to float32
when the bundle loads, so serving sees only the one-time rounding.

``ServingModel.predict`` routes a scene to the least-padded bucket that
fits, copies it on the host, in the order of its own memory, into a
staging buffer (one per batch and bucket, made once and reused: pinned
for the card), uploads the staged values, zero-pads them to NCHW on the
device, runs the artifact and crops back, as
``evaluation.scene_probabilities`` pads and crops: on bucket-sized scenes
the served probabilities are the assessment pipeline's.
"""

from __future__ import annotations

import copy
import io
import itertools
import json
import os
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from . import tracing
from .device import resolve_device

DEFAULT_BUCKETS = ((256, 256), (512, 512), (1024, 1024))
# the host copy into a staging buffer: pieces of at least this many bytes
# of a scene, over at most this many threads (a ~1000² scene pair copies in
# ~3.5 ms over 8 threads of an H100's 8-core host, ~9.7 ms in one)
_PIECE_BYTES = 2 << 20
_COPY_THREADS = min(8, os.cpu_count() or 1)
_PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def _platforms(platforms, model) -> list:
    """Canonical platform names; None is the platform of ``model``'s
    device."""
    if platforms is None:
        platforms = [next(model.parameters()).device.type]
    elif isinstance(platforms, str):  # list("cpu") would be ['c', 'p', 'u']
        platforms = [platforms]
    out = []
    for p in platforms:
        if p not in _PLATFORMS:
            raise ValueError(f"unknown serving platform {p!r}; known: "
                             f"{sorted(_PLATFORMS)}")
        if _PLATFORMS[p] not in out:
            out.append(_PLATFORMS[p])
    if "cuda" in out and not torch.cuda.is_available():
        raise RuntimeError("exporting for the cuda platform needs a CUDA "
                           "device; this host has none")
    return out


def _artifact_name(platform: str, b: int, h: int, w: int) -> str:
    stem = f"fwd_{h}x{w}" if b == 1 else f"fwd_b{b}_{h}x{w}"
    return f"{platform}/{stem}.pt2"


class _Probabilities(torch.nn.Module):
    """``model``'s :func:`.train_lib.probabilities` as a module."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        from .train_lib import probabilities  # the export needs it, loading not

        return probabilities(self.model, x1, x2)


class _Forward(torch.nn.Module):
    """``(leaves, x1, x2) -> probabilities`` with ``model``'s weights bound
    from ``leaves`` (state_dict order) for each call. The model is held
    outside the module tree, so the export lifts none of its tensors into
    the artifact."""

    def __init__(self, model, names: list):
        super().__init__()
        self.__dict__["inner"] = _Probabilities(model)
        self.names = [f"model.{n}" for n in names]

    def forward(self, leaves: list, x1: torch.Tensor, x2: torch.Tensor):
        return torch.func.functional_call(
            self.inner, dict(zip(self.names, leaves)), (x1, x2), strict=True)


def export_serving_bundle(model, cfg, path, buckets=DEFAULT_BUCKETS,
                          platforms=None, weights_dtype: str = "fp32",
                          batch_sizes=(1,)) -> Path:
    """Export ``model``'s eval forward for each ``(h, w)`` bucket, batch size
    and platform into a self-contained serving bundle at ``path``."""
    if weights_dtype not in ("fp32", "bf16"):
        raise ValueError(f"weights_dtype must be fp32|bf16, got {weights_dtype!r}")
    # batch 1 is always exported: predict() routes through it
    batch_sizes = sorted(set(int(b) for b in batch_sizes) | {1})
    if batch_sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
    platforms = _platforms(platforms, model)

    # NCHW leaves, strides and all, whatever the model's layout (one trained
    # on the card holds channels-last weights): one artifact for either
    state = {k: v.detach().cpu().clone(memory_format=torch.contiguous_format)
             for k, v in model.state_dict().items()}
    if weights_dtype == "bf16":
        state = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
                 for k, v in state.items()}
    names = list(state)
    leaves = list(state.values())

    n_ch = (len(cfg.DATALOADER.S1_BANDS), len(cfg.DATALOADER.S2_BANDS))
    in_channels = {"s1": n_ch[0], "s2": n_ch[1],
                   "s1s2": n_ch[0] + n_ch[1]}[cfg.DATALOADER.INPUT_MODE]
    model_dtype = getattr(model, "compute_dtype", torch.float32)
    compute = {p: str(model_dtype if p == "cuda" else torch.float32)
               for p in platforms}

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        for platform in platforms:
            device = torch.device(platform)
            m = copy.deepcopy(model).to(device).eval()
            example = [_widen(l).to(device) for l in leaves]
            fwd = _Forward(m, names)
            for h, w in buckets:
                for b in batch_sizes:
                    # two tensors: one passed twice would be traced as one
                    # input, and the artifact would read x1 for x2
                    x1, x2 = (torch.zeros((b, in_channels, h, w), device=device)
                              for _ in range(2))
                    exported = torch.export.export(fwd, (example, x1, x2))
                    if exported.state_dict or exported.constants:
                        raise RuntimeError("the exported forward captured "
                                           "model tensors; it must take "
                                           "every weight as an input")
                    # the trace's example inputs (the weights and two
                    # scenes) would be saved with every artifact
                    exported.example_inputs = None
                    buf = io.BytesIO()
                    torch.export.save(exported, buf)
                    z.writestr(_artifact_name(platform, b, h, w), buf.getvalue())
            del m, example

        buf = io.BytesIO()
        # np.savez cannot hold bfloat16: those leaves ride as their uint16
        # bit patterns, and the loader views them back
        np.savez(buf, **{k: v.view(torch.int16).numpy().view(np.uint16)
                         if v.dtype == torch.bfloat16 else v.numpy()
                         for k, v in state.items()})
        z.writestr("variables.npz", buf.getvalue())
        z.writestr("meta.json", json.dumps({
            "buckets": [list(b) for b in buckets],
            "batch_sizes": batch_sizes,
            "weights_dtype": weights_dtype,
            "bf16_leaves": [i for i, v in enumerate(leaves)
                            if v.dtype == torch.bfloat16],
            "model_type": cfg.MODEL.TYPE,
            "input_mode": cfg.DATALOADER.INPUT_MODE,
            "in_channels": in_channels,
            "torch_version": torch.__version__,
            "platforms": platforms,
            "compute_dtype": compute,
        }))
    return path


def _widen(leaf: torch.Tensor) -> torch.Tensor:
    """A bf16-stored weight as the float32 the forward computes with."""
    return leaf.float() if leaf.dtype == torch.bfloat16 else leaf


class ServingModel:
    """A loaded serving bundle on ``device`` (default: the card; ``"cpu"``
    runs the bundle's ``cpu`` artifacts). ``predict(x_t1, x_t2)`` takes
    ``(H, W, C)`` float scenes and returns ``(H, W)`` float32 change
    probabilities; ``predict_batch`` scores many scene pairs through the
    batched artifacts.

    Scenes reach an artifact through a host staging buffer per ``(batch,
    bucket)``, made at its first call and reused by every later one
    (pinned memory on the card, plain memory on the CPU), and are
    zero-padded on the device. ``staging_stats()`` counts the staged
    calls, pinned or not, and the buffers made. Concurrent callers are
    safe: the staging is done under a lock."""

    def __init__(self, path, device=None):
        self._path = Path(path)
        self.device = resolve_device(device)
        self.platform = self.device.type
        try:
            with zipfile.ZipFile(self._path) as z:
                self._load(z)
        except FileNotFoundError:
            raise
        except Exception as e:
            # name the bundle: zipfile/json/npz raise member- or
            # format-level errors that don't identify the file
            raise ValueError(
                f"Corrupt or incompatible serving bundle {self._path}: "
                f"{type(e).__name__}: {e}") from e
        self._fns: dict = {}
        self._calls = itertools.count(1)   # ids of the predict spans
        # (b, bh, bw) -> (host buffer, event of the upload that last read
        # it; None on the CPU, whose copies are done when they return)
        self._staging: dict = {}
        self._pinned = self.device.type == "cuda"
        self._lock = threading.Lock()
        self._pool = None   # the staging copy's threads, made at first need
        self._counts = {"calls": 0, "pinned": 0, "unpinned": 0, "allocations": 0}

    def _load(self, z) -> None:
        meta = json.loads(z.read("meta.json"))
        if self.platform not in meta["platforms"]:
            raise ValueError(f"no artifacts for platform {self.platform!r} "
                             f"(exported for {meta['platforms']})")
        npz = np.load(io.BytesIO(z.read("variables.npz")))
        bf16_leaves = set(meta["bf16_leaves"])
        leaves = []
        for i, k in enumerate(npz.files):
            arr = npz[k]
            t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                 if i in bf16_leaves else torch.from_numpy(arr))
            leaves.append(_widen(t).to(self.device))
        self.leaves = leaves
        self.meta = meta
        self.buckets = sorted(tuple(b) for b in meta["buckets"])
        self.batch_sizes = sorted(meta["batch_sizes"])

    def _fn(self, key):
        # artifacts are read and loaded lazily per (b, h, w) on first use,
        # so a predict()-only consumer never loads the batched or
        # other-bucket ones
        if key not in self._fns:
            b, bh, bw = key
            with zipfile.ZipFile(self._path) as z:
                data = z.read(_artifact_name(self.platform, b, bh, bw))
            self._fns[key] = torch.export.load(io.BytesIO(data)).module()
        return self._fns[key]

    def _bucket_for(self, h, w):
        fits = [(bh * bw, bh, bw) for bh, bw in self.buckets
                if bh >= h and bw >= w]
        if not fits:
            raise ValueError(
                f"scene {h}x{w} exceeds every exported bucket "
                f"{self.buckets}; re-export with a larger bucket")
        _, bh, bw = min(fits)  # least padded area among the fitting buckets
        return bh, bw

    def _check_pair(self, x_t1, x_t2):
        if np.ndim(x_t1) != 3:
            raise ValueError(f"expected an unbatched (H, W, C) scene, got "
                             f"shape {np.shape(x_t1)}")
        h, w, c = x_t1.shape
        if x_t2.shape != x_t1.shape:
            raise ValueError(f"bitemporal shapes differ: x_t1 {x_t1.shape} "
                             f"vs x_t2 {x_t2.shape}")
        if c != self.meta["in_channels"]:
            raise ValueError(f"expected {self.meta['in_channels']} channels "
                             f"({self.meta['input_mode']}), got {c}")
        return h, w

    def staging_stats(self) -> dict:
        """Staged artifact calls (``calls``, split into ``pinned`` and
        ``unpinned``), staging buffers made (``allocations``) and the share
        of calls that found theirs made (``reuse``, 1 - allocations /
        calls; None before the first call)."""
        with self._lock:
            out = dict(self._counts)
        out["reuse"] = 1 - out["allocations"] / out["calls"] if out["calls"] else None
        return out

    def _staging_slot(self, key) -> list:
        """``key``'s staging buffer and the event of its last upload: room
        for both dates of ``b`` pairs, made at the key's first call."""
        slot = self._staging.get(key)
        if slot is None:
            b, bh, bw = key
            n = 2 * b * bh * bw * self.meta["in_channels"]
            slot = (torch.empty(n, dtype=torch.float32, pin_memory=self._pinned),
                    torch.cuda.Event() if self._pinned else None)
            self._staging[key] = slot
            self._counts["allocations"] += 1
        return slot

    def _copy(self, jobs: list) -> None:
        """Run the ``(dst, src)`` host copies, each cut along its outer axis
        into up to ``_COPY_THREADS`` pieces of at least ``_PIECE_BYTES`` and
        spread over a pool of threads when there is more than one piece
        (numpy releases the interpreter lock while it copies)."""
        pieces = []
        for dst, src in jobs:
            k = int(np.clip(src.nbytes // _PIECE_BYTES, 1, _COPY_THREADS))
            ax = 0 if src.shape[0] >= k else 1
            cuts = np.linspace(0, src.shape[ax], k + 1).astype(int)
            for lo, hi in zip(cuts[:-1], cuts[1:]):
                at = (slice(None),) * ax + (slice(lo, hi),)
                pieces.append((dst[at], src[at]))
        if len(pieces) == 1:
            np.copyto(*pieces[0], casting="unsafe")
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(_COPY_THREADS, "serve-stage")
        for f in [self._pool.submit(np.copyto, dst, src, casting="unsafe")
                  for dst, src in pieces]:
            f.result()

    def _run(self, b: int, bh: int, bw: int, chunk: list) -> list:
        """One artifact call on ``chunk`` (at most ``b`` pairs). Each scene is
        staged on the host in the order of its own memory (an ``(H, W, C)``
        array as is; a channel-planar view of a ``(C, H, W)`` one plane
        after plane), date 1's pairs then date 2's, packed, so the copy
        reads it front to back; the staged values are uploaded and
        zero-padded to ``(b, C, bh, bw)`` float32 NCHW on the device; the
        per-pair maps are cropped back."""
        c = self.meta["in_channels"]
        scenes = [[np.asarray(pair[d]) for pair in chunk] for d in range(2)]
        # each scene's axes, outermost in memory first
        orders = [[sorted(range(3), key=lambda i: -abs(a.strides[i])) for a in date]
                  for date in scenes]
        starts = np.cumsum([0] + [a.size for a in scenes[0]]).tolist()
        n = starts[-1]
        with self._lock, torch.inference_mode():
            # the copies into the staging buffer, cast to float32: no
            # zero-filled padding, no transpose on the host
            with tracing.span("serve.pad"):
                host, uploaded = self._staging_slot((b, bh, bw))
                if uploaded is not None:
                    uploaded.synchronize()   # the last upload has read it
                flat = host.numpy()
                jobs = []
                for d in range(2):
                    for j, (a, order) in enumerate(zip(scenes[d], orders[d])):
                        src = a.transpose(order)
                        lo = d * n + starts[j]
                        jobs.append((flat[lo:lo + a.size].reshape(src.shape), src))
                self._copy(jobs)
                self._counts["calls"] += 1
                self._counts["pinned" if self._pinned else "unpinned"] += 1
            # one upload of the staged values (on the CPU device, the
            # buffer itself), then the zero-padded NCHW inputs made there
            with tracing.span("serve.copy_in"):
                staged = host[:2 * n].to(self.device, non_blocking=True)
                if uploaded is not None:
                    uploaded.record()
                x = [torch.zeros((b, c, bh, bw), device=self.device) for _ in range(2)]
                for d in range(2):
                    for j, (a, order) in enumerate(zip(scenes[d], orders[d])):
                        h, w = a.shape[:2]
                        lo = d * n + starts[j]
                        x[d][j, :, :h, :w] = (staged[lo:lo + a.size]
                                              .view([a.shape[i] for i in order])
                                              .permute(order.index(2), order.index(0),
                                                       order.index(1)))
        with torch.inference_mode():
            # the artifact's launches (its first call loads it)
            with tracing.span("serve.forward"):
                out = self._fn((b, bh, bw))(self.leaves, *x)
            # waiting for the device, then the copy back
            with tracing.span("serve.fetch"):
                probs = out.cpu().numpy()
        return [probs[j, 0, :a.shape[0], :a.shape[1]] for j, a in enumerate(scenes[0])]

    def predict(self, x_t1: np.ndarray, x_t2: np.ndarray) -> np.ndarray:
        tracing.follow_profiler()
        with tracing.span("serve.predict", next(self._calls)):
            h, w = self._check_pair(x_t1, x_t2)
            return self._run(1, *self._bucket_for(h, w), [(x_t1, x_t2)])[0]

    def predict_batch(self, pairs) -> list:
        """Score ``[(x_t1, x_t2), ...]`` scene pairs; returns per-pair (H, W)
        probability arrays in input order. Pairs sharing a size bucket are
        stacked and run through the largest exported batch artifact that
        fits, a partial final chunk through the smallest exported batch
        that holds it, zero-padded on the batch axis."""
        tracing.follow_profiler()
        with tracing.span("serve.predict", next(self._calls)):
            results: list = [None] * len(pairs)
            groups: dict = {}
            for i, (x1, x2) in enumerate(pairs):
                h, w = self._check_pair(x1, x2)
                groups.setdefault(self._bucket_for(h, w), []).append(i)

            max_b = self.batch_sizes[-1]
            for (bh, bw), members in groups.items():
                for start in range(0, len(members), max_b):
                    idx = members[start:start + max_b]
                    b = next(b for b in self.batch_sizes if b >= len(idx))
                    for i, probs in zip(idx, self._run(b, bh, bw,
                                                       [pairs[i] for i in idx])):
                        results[i] = probs
            return results


def load_serving_bundle(path, device=None) -> ServingModel:
    return ServingModel(path, device=device)
