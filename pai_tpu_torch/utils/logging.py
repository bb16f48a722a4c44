"""CSV metric logger, counterpart of ``pai_tpu/utils/logging.py``: the
Lightning ``CSVLogger`` layout the reference relies on,
``<save_dir>/<name>/version_<k>/metrics.csv`` (rows of ``epoch``, ``step``
and the metrics logged; the header grows when a new metric appears, the file
rewritten under the grown header) plus ``hparams.yaml``. Palette validation
writes its sampled PNGs under the same version directory.

``hparams.yaml`` is written by ``dump_yaml``, a writer of the port's own for
a flat mapping of scalars and lists (``yaml`` need not be installed beside
the card): keys sorted, as ``yaml.safe_dump`` sorts them, each value as YAML
reads it back — ``null``, ``true``/``false``, numbers (floats always with a
dot, as YAML 1.1 wants them), strings and lists in JSON's spelling, which is
YAML's flow style.
"""

from __future__ import annotations

import csv
import json
import math
import os
from typing import Dict, Mapping, Optional


def _yaml_scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float) and not math.isfinite(value):
        return ".nan" if math.isnan(value) else (".inf" if value > 0
                                                 else "-.inf")
    if isinstance(value, float):
        # YAML 1.1 reads 1e-06 as a string: its floats need a dot
        mantissa, _, exponent = repr(value).partition("e")
        if exponent and "." not in mantissa:
            mantissa += ".0"
        return mantissa + ("e" + exponent if exponent else "")
    if isinstance(value, (int, str)):
        return json.dumps(value)
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(v) for v in value) + "]"
    raise TypeError(f"dump_yaml cannot write a {type(value).__name__}")


def dump_yaml(mapping: Mapping) -> str:
    """A flat mapping of scalars and lists as YAML text."""
    return "".join(f"{json.dumps(str(k))}: {_yaml_scalar(mapping[k])}\n"
                   for k in sorted(mapping))


class CSVLogger:
    def __init__(self, save_dir: str, name: str):
        base = os.path.join(save_dir, name)
        os.makedirs(base, exist_ok=True)
        version = 0
        while os.path.exists(os.path.join(base, f"version_{version}")):
            version += 1
        self.log_dir = os.path.join(base, f"version_{version}")
        os.makedirs(self.log_dir, exist_ok=True)
        self._path = os.path.join(self.log_dir, "metrics.csv")
        self._fieldnames = ["epoch", "step"]
        self._appendable = False  # header not yet on disk

    def log_hparams(self, hparams: Mapping) -> None:
        with open(os.path.join(self.log_dir, "hparams.yaml"), "w") as f:
            f.write(dump_yaml(hparams))

    def log_metrics(self, metrics: Dict[str, float], step: int,
                    epoch: Optional[int] = None) -> None:
        row = {"step": step}
        if epoch is not None:
            row["epoch"] = epoch
        new_fields = False
        for k, v in metrics.items():
            row[k] = float(v)
            if k not in self._fieldnames:
                self._fieldnames.append(k)
                new_fields = True
        if new_fields and self._appendable:
            self._rewrite_header()
        with open(self._path, "a" if self._appendable else "w",
                  newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            if not self._appendable:
                writer.writeheader()
            writer.writerow(row)
        self._appendable = True

    def _rewrite_header(self) -> None:
        """Stream the file through a copy under the grown header, then
        replace it: one row at a time, whatever the file's length."""
        tmp = self._path + ".tmp"
        with open(self._path, newline="") as src, \
                open(tmp, "w", newline="") as dst:
            writer = csv.DictWriter(dst, fieldnames=self._fieldnames)
            writer.writeheader()
            for row in csv.DictReader(src):
                writer.writerow(row)
        os.replace(tmp, self._path)
