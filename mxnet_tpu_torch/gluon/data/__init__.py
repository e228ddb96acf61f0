"""Gluon data API: datasets, samplers, batchify functions, ``DataLoader``
and the vision datasets and transforms.

Counterpart of ``mxnet_tpu/gluon/data/``."""
from . import batchify, vision
from .dataloader import DataLoader, default_batchify_fn
from .dataset import (ArrayDataset, Dataset, RecordFileDataset,
                      SimpleDataset)
from .sampler import (BatchSampler, FilterSampler, IntervalSampler,
                      RandomSampler, Sampler, SequentialSampler)

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "DataLoader",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "IntervalSampler", "vision", "batchify",
           "default_batchify_fn"]
