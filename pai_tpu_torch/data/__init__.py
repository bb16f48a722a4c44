"""Data pipeline of the port: manifest -> host PNG decode/resize -> uint8
batches -> pinned-memory copy to the device -> normalisation on the device."""

from pai_tpu_torch.data.manifest import load_manifest
from pai_tpu_torch.data.pipeline import Batch, BatchLoader, ImageDataset
