"""Data pipeline of the port: manifest -> host PNG decode/resize -> uint8
batches -> pinned-memory copy to the device -> normalisation on the device;
``ImageDataModule``, the reference's data-module facade over it."""

from pai_tpu_torch.data.manifest import load_manifest
from pai_tpu_torch.data.pipeline import Batch, BatchLoader, ImageDataset
from pai_tpu_torch.data.datamodule import ImageDataModule
