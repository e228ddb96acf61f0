"""Vision datasets: ``MNIST``, ``FashionMNIST``, ``CIFAR10``, ``CIFAR100``,
``ImageRecordDataset``, ``ImageFolderDataset`` and ``ImageListDataset``.

Counterpart of ``mxnet_tpu/gluon/data/vision/datasets.py``.  When the
canonical binary files are under ``root`` they are parsed; otherwise the
JAX package's deterministic synthetic set of the same shapes, dtypes and
classes is made (the same numpy draws, so both packages hold the same
images).  Nothing is downloaded.  Images are host arrays: a dataset holds
and returns CPU NDArrays, and the ``DataLoader`` moves whole batches.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as _np

from .... import ndarray as nd
from ....context import cpu
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "ImageListDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        if not os.path.isdir(self._root):
            os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST (the idx-ubyte files, else the synthetic set)."""

    _shape = (28, 28, 1)
    _nclass = 10
    _synthetic_size = {"train": 8192, "test": 1024}

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _files(self):
        if self._train:
            return ("train-images-idx3-ubyte.gz",
                    "train-labels-idx1-ubyte.gz")
        return ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")

    def _get_data(self):
        img_f, lbl_f = (os.path.join(self._root, f) for f in self._files())
        if os.path.exists(img_f) and os.path.exists(lbl_f):
            with gzip.open(lbl_f, "rb") as f:
                struct.unpack(">II", f.read(8))
                label = _np.frombuffer(f.read(), dtype=_np.uint8) \
                    .astype(_np.int32)
            with gzip.open(img_f, "rb") as f:
                _, _, rows, cols = struct.unpack(">IIII", f.read(16))
                data = _np.frombuffer(f.read(), dtype=_np.uint8).reshape(
                    len(label), rows, cols, 1)
        else:
            data, label = self._synthesize()
        self._data = nd.array(data, ctx=cpu(), dtype="uint8")
        self._label = label

    def _synthesize(self):
        n = self._synthetic_size["train" if self._train else "test"]
        rng = _np.random.RandomState(42 if self._train else 43)
        label = rng.randint(0, self._nclass, size=n).astype(_np.int32)
        data = _np.zeros((n,) + self._shape, dtype=_np.uint8)
        # class-dependent blobs so models can actually learn
        for i in range(n):
            c = label[i]
            img = rng.rand(*self._shape) * 32
            r, col = divmod(int(c), 4)
            img[4 + r * 6:10 + r * 6, 4 + col * 5:10 + col * 5, :] += 180
            data[i] = _np.clip(img, 0, 255).astype(_np.uint8)
        return data, label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    _shape = (32, 32, 3)
    _nclass = 10
    _synthetic_size = {"train": 8192, "test": 1024}

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        data = _np.fromfile(filename, dtype=_np.uint8).reshape(-1, 3073)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(_np.int32)

    def _get_data(self):
        files = (["data_batch_%d.bin" % i for i in range(1, 6)]
                 if self._train else ["test_batch.bin"])
        paths = [os.path.join(self._root, f) for f in files]
        if all(os.path.exists(p) for p in paths):
            data, label = zip(*[self._read_batch(p) for p in paths])
            data = _np.concatenate(data)
            label = _np.concatenate(label)
        else:
            data, label = self._synthesize()
        self._data = nd.array(data, ctx=cpu(), dtype="uint8")
        self._label = label

    def _synthesize(self):
        n = self._synthetic_size["train" if self._train else "test"]
        rng = _np.random.RandomState(44 if self._train else 45)
        label = rng.randint(0, self._nclass, size=n).astype(_np.int32)
        data = _np.zeros((n,) + self._shape, dtype=_np.uint8)
        for i in range(n):
            c = int(label[i])
            img = rng.rand(*self._shape) * 48
            img[:, :, c % 3] += 100
            r, col = divmod(c, 4)
            img[4 + r * 8:12 + r * 8, 4 + col * 7:12 + col * 7, :] += 100
            data[i] = _np.clip(img, 0, 255).astype(_np.uint8)
        return data, label


class CIFAR100(CIFAR10):
    _nclass = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)


class ImageRecordDataset(Dataset):
    """Images and labels of a RecordIO pack (``filename`` and its
    ``.idx``)."""

    def __init__(self, filename, flag=1, transform=None):
        from ....recordio import MXIndexedRecordIO, unpack_img

        self._record = MXIndexedRecordIO(
            os.path.splitext(filename)[0] + ".idx", filename, "r")
        self._transform = transform
        self._flag = flag
        self._unpack_img = unpack_img

    def __getitem__(self, idx):
        record = self._record.read_idx(self._record.keys[idx])
        header, img = self._unpack_img(record)
        img_nd = nd.array(img, ctx=cpu(), dtype="uint8")
        label = header.label
        if self._transform is not None:
            return self._transform(img_nd, label)
        return img_nd, label

    def __len__(self):
        return len(self._record.keys)


class ImageFolderDataset(Dataset):
    """Images in one folder per class."""

    def __init__(self, root, flag=1, transform=None, exts=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = exts or [".jpg", ".jpeg", ".png", ".npy"]
        self.synsets = []
        self.items = []
        self._list_images(self._root)

    def _list_images(self, root):
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = _np.load(path)
        else:
            from ....image import imread

            img = imread(path).asnumpy()
        img_nd = nd.array(img, ctx=cpu(), dtype="uint8")
        if self._transform is not None:
            return self._transform(img_nd, label)
        return img_nd, label

    def __len__(self):
        return len(self.items)


class ImageListDataset(Dataset):
    """Images named by an imglist: either a
    .lst-style text file (``index\\tlabel...\\trelpath`` per line) or a
    python list whose items are ``[label(s)..., relpath]``.  Labels load
    as float arrays; multi-value labels keep their full vector."""

    def __init__(self, root=".", imglist=None, flag=1):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self.items = []   # (path, label ndarray)
        if isinstance(imglist, str):
            fname = os.path.join(self._root, imglist)
            with open(fname, "rt") as fin:
                for lineno, line in enumerate(fin, 1):
                    if not line.strip():
                        continue
                    parts = line.strip().split("\t")
                    if len(parts) < 3:
                        raise ValueError(
                            "%s:%d: expected 'index\\tlabel...\\tpath' "
                            "(tab-separated, >=3 fields), got %r"
                            % (fname, lineno, line.strip()))
                    label = _np.asarray(parts[1:-1], _np.float32)
                    self.items.append(
                        (os.path.join(self._root, parts[-1]), label))
        elif isinstance(imglist, (list, tuple)):
            for img in imglist:
                if not isinstance(img[-1], str):
                    raise ValueError(
                        "imglist entries end with the image path: %r"
                        % (img,))
                raw = img[:-1]
                if len(raw) == 1 and not _np.isscalar(raw[0]):
                    label = _np.asarray(raw[0], _np.float32)
                else:
                    label = _np.asarray(raw, _np.float32)
                self.items.append(
                    (os.path.join(self._root, img[-1]), label))
        else:
            raise ValueError("imglist must be a path or a list")

    def __getitem__(self, idx):
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = _np.load(path)
            # preserve pre-processed dtypes (float .npy stays float)
            return (nd.array(img, ctx=cpu(), dtype=str(img.dtype)),
                    nd.array(label, ctx=cpu()))
        from ....image import imread

        img = imread(path, flag=self._flag).asnumpy()
        return (nd.array(img, ctx=cpu(), dtype="uint8"),
                nd.array(label, ctx=cpu()))

    def __len__(self):
        return len(self.items)
