"""The pruned keypoint dataset and its prefetching batch loader.

The port's copy of ``perseus_tpu/data/dataset.py``. :class:`PrunedKeypointDataset`
reads either layout of :mod:`perseus_tpu_torch.data.schema`:

  * the pruned HDF5 with its image files (needs ``h5py`` and ``PIL``):
    metadata in RAM, each row decoded from its PNG / float TIFF /
    segmentation PNG on access, the segmentation binarized as
    ``seg == asset_id + 1``; with ``cache=True`` the split is decoded once
    into the compact cache (RGB ``uint8``, depth ``f32``, segmentation
    ``bool``) and rows are materialized from it;
  * a decoded split directory: that compact cache on disk, memory-mapped,
    rows materialized by the same :meth:`_materialize`, so a row is bit for
    bit what a fresh decode gives.

Rows are channels-last numpy arrays (``image`` (H, W, 3) f32 in [0, 1],
``depth_image`` and ``segmentation_image`` (H, W) f32,
``pixel_coordinates`` (K, 2), ``weight``). :class:`PrefetchingLoader`
yields batches of them from a background thread, in an order drawn from
(seed, epoch). With ``KeypointDatasetConfig.native_decode`` an HDF5 split
decodes whole batches (and fills its cache) through the C++ thread-pool
decoder of ``native/io.py`` (``decode_threads`` threads, 0: one per CPU)
where it is available, else through PIL, row for row bit-identical; a batch
in which the decoder reports a failure is decoded again item by item, so
the error surfaces from PIL. :attr:`PrunedKeypointDataset.decoder` records
which path a dataset took.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass

import numpy as np

from perseus_tpu_torch import ROOT
from perseus_tpu_torch.data import schema

__all__ = ["KeypointDatasetConfig", "PrunedKeypointDataset", "PrefetchingLoader"]


@dataclass(frozen=True)
class KeypointDatasetConfig:
    """The keypoint dataset's configuration (the JAX package's fields and
    defaults). ``dataset_path``: a pruned HDF5 or a decoded split
    directory, relative to the repository root unless absolute."""

    dataset_path: str = "data/pruned_dataset/pruned.hdf5"
    lazy: bool = True
    # decode HDF5 batches with the C++ thread-pool decoder (native/io.py)
    # where it is available; the PIL path otherwise
    native_decode: bool = True
    decode_threads: int = 0  # 0 = one per CPU


class PrunedKeypointDataset:
    """Flat per-image dataset over one split of a pruned dataset.

    ``decoder`` is the path its rows come from: "decoded split" (the numpy
    layout, nothing to decode), "native" (the C++ batch decoder) or "pil".
    """

    def __init__(self, cfg: KeypointDatasetConfig, train: bool = True, cache: bool = False):
        self.cfg = cfg
        self.train = train

        dataset_path = cfg.dataset_path
        if not dataset_path.startswith("/"):
            dataset_path = os.path.join(ROOT, dataset_path)
        self.dataset_path = dataset_path
        self.data_root = os.path.dirname(os.path.dirname(dataset_path))

        self._cache: dict | None = None
        if schema.is_decoded_split(dataset_path):
            self.split, attrs, self._cache = schema.read_decoded_split(dataset_path, train=train)
        else:
            self.split, attrs = schema.read_pruned_split(dataset_path, train=train)
        self.H = int(attrs["H"])
        self.W = int(attrs["W"])
        self.num_keypoints = int(attrs.get("num_keypoints", 8))
        self.pixel_coordinates = self.split.pixel_coordinates
        self.asset_ids = self.split.asset_ids
        self.weights = self.split.weights

        if self._cache is not None:
            self.decoder = "decoded split"
        else:
            native = False
            if cfg.native_decode:
                from perseus_tpu_torch.native import io as native_io

                native = native_io.available()
            self.decoder = "native" if native else "pil"

        # Compact columnar cache: RGB as uint8 (u8 -> f32/255 is the exact
        # decode conversion, so materialized rows are bit-identical to a
        # fresh decode), segmentation as bool, depth as f32. Filled
        # chunkwise so the peak never holds a second full-split f32 copy.
        if cache and self._cache is None and len(self):
            n, h, w = len(self), self.H, self.W
            cc = {
                "image_u8": np.empty((n, h, w, 3), np.uint8),
                "depth_image": np.empty((n, h, w), np.float32),
                "seg_b": np.empty((n, h, w), np.bool_),
            }
            step = 2048
            for s in range(0, n, step):
                idx = np.arange(s, min(s + step, n))
                if self.decoder == "native":
                    b = self.batch(idx)
                else:
                    items = [self._load(int(i)) for i in idx]
                    b = {k: np.stack([it[k] for it in items]) for k in items[0]}
                cc["image_u8"][s : s + step] = np.round(b["image"] * 255.0).astype(np.uint8)
                cc["depth_image"][s : s + step] = b["depth_image"]
                cc["seg_b"][s : s + step] = b["segmentation_image"] > 0.5
            self._cache = cc

    def __len__(self) -> int:
        return len(self.split)

    def _resolve(self, local_name: str) -> str:
        # stored filenames are relative to the dataset's data root
        return os.path.join(self.data_root, local_name)

    def _load(self, idx: int) -> dict:
        image = schema.load_rgb_png(self._resolve(self.split.image_filenames[idx]))
        depth = schema.load_depth_tiff(self._resolve(self.split.depth_filenames[idx]))
        seg_raw = schema.load_segmentation_png(self._resolve(self.split.segmentation_filenames[idx]))
        segmentation = (seg_raw == self.asset_ids[idx] + 1).astype(np.float32)
        return {
            "image": image,  # (H, W, 3) float32 [0, 1]
            "depth_image": depth.astype(np.float32),  # (H, W)
            "segmentation_image": segmentation,  # (H, W) {0, 1}
            "pixel_coordinates": self.pixel_coordinates[idx],  # (K, 2)
            "weight": np.float32(self.weights[idx]),
        }

    def _materialize(self, idx) -> dict:
        """Rows from the compact cache, restored to the decoded layout.
        `idx` may be an int or an index array (vectorized gather)."""
        cc = self._cache
        return {
            "image": cc["image_u8"][idx].astype(np.float32) / 255.0,
            "depth_image": np.asarray(cc["depth_image"][idx]),
            "segmentation_image": cc["seg_b"][idx].astype(np.float32),
            "pixel_coordinates": self.pixel_coordinates[idx],
            "weight": np.float32(self.weights[idx])
            if np.isscalar(idx) or np.ndim(idx) == 0
            else np.asarray(self.weights[idx], np.float32),
        }

    def __getitem__(self, idx: int) -> dict:
        if self._cache is not None:
            return self._materialize(int(idx))
        return self._load(idx)

    def batch(self, indices: np.ndarray) -> dict:
        """Stacks examples into contiguous (B, ...) arrays. With the native
        decoder the whole batch decodes in one GIL-free C++ thread-pool call
        straight into the output buffers."""
        if self._cache is not None:
            return self._materialize(np.asarray(indices, dtype=np.int64))
        if self.decoder == "native":
            from perseus_tpu_torch.native import io as native_io

            idx = [int(i) for i in indices]
            rgb, depth, seg, failures = native_io.decode_batch(
                [self._resolve(self.split.image_filenames[i]) for i in idx],
                [self._resolve(self.split.depth_filenames[i]) for i in idx],
                [self._resolve(self.split.segmentation_filenames[i]) for i in idx],
                np.asarray([self.asset_ids[i] for i in idx]),
                self.H,
                self.W,
                threads=self.cfg.decode_threads,
            )
            if failures:  # item by item, so that the failing file raises its own error
                items = [self._load(i) for i in idx]
                return {k: np.stack([it[k] for it in items]) for k in items[0]}
            return {
                "image": rgb,
                "depth_image": depth,
                "segmentation_image": seg,
                "pixel_coordinates": np.stack([self.pixel_coordinates[i] for i in idx]),
                "weight": np.asarray([self.weights[i] for i in idx], dtype=np.float32),
            }
        items = [self[int(i)] for i in indices]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


class PrefetchingLoader:
    """Background-thread batch loader with a bounded prefetch queue.

    Epoch order is a deterministic permutation of (seed, epoch) (with
    ``sample_weights``: a draw with replacement proportional to them). For
    data-parallel training, pass (shard_index, num_shards) to iterate this
    process's block of each global batch.
    """

    def __init__(
        self,
        dataset: PrunedKeypointDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        shard_index: int = 0,
        num_shards: int = 1,
        sample_weights: np.ndarray | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.sample_weights = None
        if sample_weights is not None and shuffle:
            w = np.asarray(sample_weights, np.float64)
            self.sample_weights = w / w.sum()

    def epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.sample_weights is not None:
            order = np.random.default_rng((self.seed, epoch)).choice(
                n, size=n, replace=True, p=self.sample_weights
            )
        elif self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(n)
        else:
            order = np.arange(n)
        if self.num_shards == 1 and not self.drop_last:
            return order
        # Batch-blocked sharding, wrap-padded to whole global batches: global
        # batch b is order[b*gB:(b+1)*gB] and shard p takes the p-th
        # contiguous block within each, so any shard count iterates the same
        # global batches, and the same number of steps, as one process.
        global_bs = self.batch_size * self.num_shards
        n_pad = -(-n // global_bs) * global_bs
        padded = np.resize(order, n_pad)
        blocks = padded.reshape(-1, self.num_shards, self.batch_size)
        return blocks[:, self.shard_index].reshape(-1)

    def num_batches(self) -> int:
        n = len(self.epoch_indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0):
        """Yields prefetched batches for one epoch."""
        order = self.epoch_indices(epoch)
        nb = self.num_batches()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that stays responsive to consumer shutdown
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    idx = order[b * self.batch_size : (b + 1) * self.batch_size]
                    if not put(self.dataset.batch(idx)):
                        return
                put(None)
            except BaseException as exc:  # surface decode errors in the consumer, which re-raises
                put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
