"""Host-side image pipeline with threaded prefetch, counterpart of
``pai_tpu/data/pipeline.py``.

Per item: PNG decoded as grayscale, antialiased (triangle-filter) resize to
``image_size`` when the file is another size — rounded to uint8 before
normalising, like torchvision's uint8 ``Resize`` — then float32 in [0,1] and
``(x - 0.5) / 0.5``.

Batches are assembled as **uint8** on the host (decode runs in a thread pool;
``zlib`` releases the interpreter lock), handed to the device through pinned
memory (one byte per pixel on the bus, not four) and converted and normalised
**on the device**. The trailing partial batch is padded to the fixed batch
shape: cycled samples for training (``pad_mode="cycle"``), zero padding with a
validity count for evaluation (``"zero"``), so per-image metrics and outputs
are exact. The order of an epoch is seeded per epoch, the same permutation the
JAX loader draws. The threaded C++ decoder of the JAX package arrives with the
training slice.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pai_tpu_torch.config import resolve_device
from pai_tpu_torch.data.manifest import load_manifest
from pai_tpu_torch.utils.images import read_png_gray


class Batch(NamedTuple):
    x: torch.Tensor    # condition image  [B, H, W, 1] float32 on the device
    y: torch.Tensor    # ground truth     [B, H, W, 1] float32 on the device
    n_valid: int       # rows < n_valid are real samples


def _triangle_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 rows of the antialiased bilinear
    (triangle) filter, torchvision ``Resize(antialias=True)`` semantics: the
    support widens with the reduction factor, each row sums to one."""
    scale = np.float32(in_size) / np.float32(out_size)
    support = max(scale, np.float32(1.0))
    weights = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        center = np.float32(i + 0.5) * scale
        lo = max(0, int(np.floor(center - support + np.float32(0.5))))
        hi = min(in_size, int(np.floor(center + support + np.float32(0.5))))
        j = np.arange(lo, hi, dtype=np.float32)
        w = np.clip(1.0 - np.abs((j + np.float32(0.5) - center) / support),
                    0.0, None).astype(np.float32)
        total = w.sum(dtype=np.float32)
        weights[i, lo:hi] = w / total if total > 0 else w
    return weights


def resize_antialias(img: np.ndarray, size: int) -> np.ndarray:
    """Antialiased resize of a uint8 [H,W] image to (size, size), float32 in
    [0, 255] (columns first, then rows). The caller rounds."""
    h, w = img.shape
    tmp = img.astype(np.float32) @ _triangle_weights(w, size).T
    return _triangle_weights(h, size) @ tmp


def load_example_u8(paths: Tuple[str, str], image_size: int = 256
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode one pair -> two [H,W,1] uint8 arrays."""
    out = []
    for p in paths:
        img = read_png_gray(p)
        if img.shape[0] != image_size or img.shape[1] != image_size:
            resized = resize_antialias(img, image_size)
            img = np.clip(resized + 0.5, 0, 255).astype(np.uint8)
        out.append(img[..., None])
    return out[0], out[1]


def normalize_u8(u8: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """uint8 -> float32 in [0,1], then (x - 0.5) / 0.5; runs where ``u8``
    lies."""
    f = u8.to(torch.float32) / 255.0
    return (f - 0.5) / 0.5 if normalize else f


def load_example(paths: Tuple[str, str], image_size: int = 256,
                 normalize: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Decode one (input, ground_truth) pair -> two [H,W,1] float32 arrays."""
    x, y = load_example_u8(paths, image_size)
    return tuple(normalize_u8(torch.from_numpy(a), normalize).numpy()
                 for a in (x, y))


class ImageDataset:
    """Paired-image dataset over a manifest."""

    def __init__(self, manifest_path: str, image_size: int = 256,
                 normalize: bool = True):
        self.pairs: List[Tuple[str, str]] = load_manifest(manifest_path)
        self.image_size = image_size
        self.normalize = normalize

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return load_example(self.pairs[idx], self.image_size, self.normalize)


class BatchLoader:
    """Threaded, prefetching batch iterator with a fixed batch shape.

    ``shuffle=True`` reshuffles every epoch with a per-epoch seed. Batches
    arrive on ``device`` (default: the card) already normalised."""

    def __init__(self, dataset: ImageDataset, batch_size: int,
                 shuffle: bool = False, pad_mode: str = "cycle",
                 seed: int = 0, num_workers: int = 8, prefetch: int = 4,
                 device: Union[str, torch.device] = "cuda"):
        if pad_mode not in ("cycle", "zero"):
            raise ValueError(f"pad_mode must be 'cycle' or 'zero': {pad_mode}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.pad_mode = pad_mode
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self.epoch = 0
        self._pool: Optional[ThreadPoolExecutor] = None

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(order)
        return order

    def epoch_batches(self) -> List[Tuple[List[int], int]]:
        """This epoch's ``(indices, n_valid)`` per batch; index -1 is a zero
        pad row. Advances the epoch counter."""
        order = self._epoch_order()
        self.epoch += 1
        bs = self.batch_size
        batches = []
        for start in range(0, len(order), bs):
            idx = [int(j) for j in order[start:start + bs]]
            n_valid = len(idx)
            if n_valid < bs:
                if self.pad_mode == "cycle":
                    idx = idx + [int(j) for j in order[: bs - n_valid]]
                else:
                    idx = idx + [-1] * (bs - n_valid)
            batches.append((idx, n_valid))
        return batches

    def _assemble_u8(self, idx: Sequence[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        size = self.dataset.image_size
        pin = self.device.type == "cuda"
        xs = torch.zeros((len(idx), size, size, 1), dtype=torch.uint8,
                         pin_memory=pin)
        ys = torch.zeros((len(idx), size, size, 1), dtype=torch.uint8,
                         pin_memory=pin)
        futures = {i: self._pool.submit(load_example_u8,
                                        self.dataset.pairs[j], size)
                   for i, j in enumerate(idx) if j >= 0}
        xs_np, ys_np = xs.numpy(), ys.numpy()
        for i, fut in futures.items():
            xs_np[i], ys_np[i] = fut.result()
        return xs, ys

    def __iter__(self) -> Iterator[Batch]:
        batches = self.epoch_batches()
        if self._pool is None:  # one pool per loader, reused across epochs
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        out_q: "queue.Queue" = queue.Queue(self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that gives up when the consumer has gone away."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idx, n_valid in batches:
                    if not _put((self._assemble_u8(idx), n_valid)):
                        return
                _put(None)
            except BaseException as exc:  # handed to the consumer, re-raised
                _put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        normalize = self.dataset.normalize
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                (xs, ys), n_valid = item
                # the copy and the conversion are made by the consuming
                # thread, on its current stream
                yield Batch(
                    normalize_u8(xs.to(self.device, non_blocking=True),
                                 normalize),
                    normalize_u8(ys.to(self.device, non_blocking=True),
                                 normalize),
                    n_valid)
        finally:
            stop.set()
            thread.join(timeout=5.0)
            while not out_q.empty():
                out_q.get_nowait()
