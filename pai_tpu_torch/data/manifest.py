"""Data-manifest parsing, counterpart of ``pai_tpu/data/manifest.py``.

A manifest is a YAML list of ``{input: <path>, ground_truth: <path>}`` entries
in block style; paths are resolved relative to the manifest's directory:

    - input: in_0.png
      ground_truth: gt_0.png

The JAX package reads it with ``yaml``; the port must run where ``yaml`` is
not installed, so it parses this one fixed shape itself: ``- key: value``
opens an entry, an indented ``key: value`` continues it, values may be quoted,
``#`` comments and blank lines are skipped. Anything else raises.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple


def _scalar(text: str) -> str:
    text = text.strip()
    if text[:1] in ("'", '"'):
        end = text.find(text[0], 1)
        rest = text[end + 1:].strip()
        if end < 0 or (rest and not rest.startswith("#")):
            raise ValueError(f"badly quoted manifest value: {text!r}")
        return text[1:end]
    if " #" in text:  # trailing comment after a plain scalar
        text = text.split(" #", 1)[0].rstrip()
    return text


def parse_manifest(text: str) -> List[Dict[str, str]]:
    """The list of ``{"input": ..., "ground_truth": ...}`` dicts of a manifest
    text, values as written."""
    entries: List[Dict[str, str]] = []
    for number, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        stripped = line.strip()
        if not stripped or stripped.startswith("#") or stripped == "---":
            continue
        opens = stripped.startswith("- ")
        if opens:
            entries.append({})
            stripped = stripped[2:].strip()
        elif not entries or line[0] not in " \t":
            raise ValueError(f"manifest line {number}: expected '- key: "
                             f"value' or an indented 'key: value': {raw!r}")
        key, sep, value = stripped.partition(":")
        if not sep or (value and value[0] not in " \t"):
            raise ValueError(f"manifest line {number}: expected "
                             f"'key: value': {raw!r}")
        entries[-1][key.strip()] = _scalar(value)
    for i, entry in enumerate(entries):
        if set(entry) != {"input", "ground_truth"} or not all(entry.values()):
            raise ValueError(
                f"manifest entry {i}: expected exactly the keys 'input' and "
                f"'ground_truth', got {sorted(entry)}")
    return entries


def load_manifest(path: str) -> List[Tuple[str, str]]:
    with open(path, "r") as f:
        entries = parse_manifest(f.read())
    base = os.path.dirname(str(path))
    return [(os.path.join(base, e["input"]),
             os.path.join(base, e["ground_truth"])) for e in entries]
