"""``ImageDataModule``, the reference's data-module facade over the port's
pipeline, counterpart of ``pai_tpu/data/datamodule.py``.

The constructor takes the reference's vocabulary, ``ImageDataModule(
data_list_file, val_list_file=None, batch_size=1, normalize=True)`` (plus
``image_size``, ``seed`` and the ``device`` batches arrive on).
``setup(stage)`` picks the splits with the reference's stage semantics:
``fit`` -> train and val, ``validate``/``test``/``predict`` -> the *data*
list. The training loader reshuffles every epoch and pads its last batch by
cycling; the others keep the order and pad with zero rows; nothing is
dropped (a batch's ``n_valid`` counts its real rows). The loaders are the port's ``BatchLoader``s, which yield
fixed-shape ``Batch(x, y, n_valid)`` tuples rather than torch (input, target)
pairs.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from pai_tpu_torch.data.pipeline import BatchLoader, ImageDataset


class ImageDataModule:
    def __init__(self, data_list_file: str,
                 val_list_file: Optional[str] = None, batch_size: int = 1,
                 normalize: bool = True, image_size: int = 256, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.data_list_file = data_list_file
        self.val_list_file = val_list_file
        self.batch_size = batch_size
        self.normalize = normalize
        self.image_size = image_size
        self.seed = seed
        self.device = device
        self._data = ImageDataset(data_list_file, image_size,
                                  normalize=normalize)
        self._val = (ImageDataset(val_list_file, image_size,
                                  normalize=normalize)
                     if val_list_file is not None else None)
        self.train_split = None
        self.val_split = None
        self.test_split = None
        self.pred_split = None

    def setup(self, stage: str) -> None:
        if stage == "fit":
            self.train_split = self._data
            self.val_split = self._val
        if stage == "validate":
            self.val_split = self._data
        if stage == "test":
            self.test_split = self._data
        if stage == "predict":
            self.pred_split = self._data

    def _loader(self, dataset: ImageDataset, shuffle: bool) -> BatchLoader:
        return BatchLoader(dataset, self.batch_size, shuffle=shuffle,
                           pad_mode="cycle" if shuffle else "zero",
                           seed=self.seed, device=self.device)

    def train_dataloader(self) -> BatchLoader:
        return self._loader(self.train_split, shuffle=True)

    def val_dataloader(self) -> BatchLoader:
        return self._loader(self.val_split, shuffle=False)

    def test_dataloader(self) -> BatchLoader:
        return self._loader(self.test_split, shuffle=False)

    def predict_dataloader(self) -> BatchLoader:
        return self._loader(self.pred_split, shuffle=False)
