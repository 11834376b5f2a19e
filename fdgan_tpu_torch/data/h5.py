"""HDF5 paired-image pipeline.

Counterpart of ``fdgan_tpu/data/h5.py``. File format parity with the
reference (datasets/pix2pix.py:62-77 and generate_testsample.py:35-38): the
dataset root holds ``{i}.h5`` files, each with float datasets ``gt`` and
``haze`` stored HWC in [0, 1].

The loader yields NHWC numpy batches from a background prefetch thread;
the caller uploads them (``cli/demo.py``). ``h5py`` is imported where a
dataset is built or read, so that the loader runs over in-memory datasets
on a machine without it; a missing ``h5py`` raises when an h5 dataset is
constructed. A ``pix2pix_val``-compatible 4-tuple variant reads DCPDN h5s
with transmission/airlight maps (datasets/pix2pix_val.py:33-89).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("h5py is required for the h5 datasets") from e
    return h5py


class PairedH5Dataset:
    """Indexable (haze, gt) dataset over ``{root}/{i}.h5`` files."""

    KEYS = ("haze", "gt")

    def __init__(self, root: str, transform=None, keys: Sequence[str] = KEYS):
        _h5py()
        self.root = root
        self.transform = transform
        self.keys = tuple(keys)
        self._len = len(glob.glob(os.path.join(root, "*h5")))

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, index: int):
        path = os.path.join(self.root, f"{index}.h5")
        with _h5py().File(path, "r") as f:
            arrays = [np.asarray(f[k][:], np.float32) for k in self.keys]
        # stored HWC already — the native layout; no swapaxes needed
        if self.transform is not None:
            arrays = self.transform(*arrays)
        return tuple(arrays)


class ValH5Dataset(PairedH5Dataset):
    """DCPDN-format validation h5s: (haze, gt, trans, ato)
    (datasets/pix2pix_val.py:84)."""

    KEYS = ("haze", "gt", "trans", "ato")

    def __init__(self, root: str, transform=None):
        super().__init__(root, transform, keys=self.KEYS)


class NewH5Dataset(PairedH5Dataset):
    """``datasets/new.py`` analog: ``input``/``target`` keys, with the
    input bilinearly resized to 224x224 before it is returned
    (datasets/new.py:190-191). Output stays HWC."""

    KEYS = ("input", "target")

    def __init__(self, root: str, transform=None, input_size: int = 224):
        super().__init__(root, transform=None, keys=self.KEYS)
        self.input_size = input_size
        self._post = transform

    def __getitem__(self, index: int):
        from fdgan_tpu_torch.data.transforms import _bilinear_resize

        inp, tgt = super().__getitem__(index)
        inp = _bilinear_resize(inp, self.input_size, self.input_size)
        if self._post is not None:
            inp, tgt = self._post(inp, tgt)
        return inp, tgt


class DataLoader:
    """Minimal batching loader with optional shuffling and a background
    prefetch thread (the reference's `num_workers` analog). ``dataset`` is
    anything with ``len`` and integer indexing that returns a tuple of
    arrays, an h5 dataset or a list of pairs."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        seed: Optional[int] = None,
        drop_last: bool = False,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def _batches(self) -> Iterator:
        idx = self._indices()
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            items = [self.dataset[int(i)] for i in chunk]
            yield tuple(np.stack(cols) for cols in zip(*items))

    def __iter__(self) -> Iterator:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            try:
                for batch in self._batches():
                    q.put(batch)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item


class ShardedDataset:
    """A strided per-process view of an indexable dataset for multi-process
    training: process ``pid`` of ``nprocs`` sees global items
    ``pid, pid+nprocs, pid+2*nprocs, ...``, truncated to the MINIMUM shard
    size so every process yields the same number of batches (a mismatched
    count would leave one process waiting in a collective the others never
    enter — a distributed hang, not an error)."""

    def __init__(self, dataset, pid: int, nprocs: int):
        if not (0 <= pid < nprocs):
            raise ValueError(f"pid {pid} out of range for {nprocs} processes")
        self.dataset = dataset
        self.pid = pid
        self.nprocs = nprocs
        self._len = len(dataset) // nprocs  # min shard size across processes

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, j: int):
        if not (0 <= j < self._len):
            raise IndexError(j)
        return self.dataset[self.pid + j * self.nprocs]


def get_loader(
    dataset_name: str,
    dataroot: str,
    original_size: int,
    image_size: int,
    batch_size: int = 64,
    workers: int = 4,
    mean=(0.5, 0.5, 0.5),
    std=(0.5, 0.5, 0.5),
    split: str = "train",
    shuffle: bool = True,
    seed: Optional[int] = None,
    shard: Optional[tuple] = None,
) -> DataLoader:
    """`misc.getLoader`/`getLoader1` equivalent (misc.py:25-116). The
    reference passes an empty transform chain for the 'pix2pix' train split
    (misc.py:42-51), so data reaches the network exactly as stored; we
    reproduce that default. `getLoader1`'s 'new' name and the folder /
    classification datasets dispatch here too (one entry point instead of
    two near-identical functions)."""
    if dataset_name == "pix2pix":
        dataset = PairedH5Dataset(dataroot)
    elif dataset_name == "pix2pix_val":
        dataset = ValH5Dataset(dataroot)
    elif dataset_name == "new":
        dataset = NewH5Dataset(dataroot)
    elif dataset_name == "folder":
        from fdgan_tpu_torch.data.folder import ImageFolder

        dataset = ImageFolder(dataroot)
    elif dataset_name == "classification":
        from fdgan_tpu_torch.data.folder import ClassificationH5

        dataset = ClassificationH5(dataroot)
    elif dataset_name == "pix2pix_val2":
        # reference datasets/pix2pix_val2.py is broken upstream (reads keys
        # the generator scripts never write — SURVEY §4.5); refuse loudly
        raise ValueError(
            "pix2pix_val2 is broken in the reference and deliberately not "
            "ported; use 'pix2pix_val' (SURVEY.md §4.5)"
        )
    else:
        raise ValueError(f"unknown dataset {dataset_name!r}")
    if shard is not None and shard[1] > 1:
        # multi-process training: each process loads only its strided slice
        # of the file list (batch_size here is the LOCAL batch)
        dataset = ShardedDataset(dataset, int(shard[0]), int(shard[1]))
    return DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=shuffle,
        seed=seed,
        prefetch=max(int(workers), 0),
    )
