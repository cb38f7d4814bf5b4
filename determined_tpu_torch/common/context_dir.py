"""Context-directory extraction: the user code an experiment ships.

A copy of the task side of ``determined_tpu/common/context_dir.py``: the
master's file store hands a task the experiment's tar.gz bundle, which
``extract`` unpacks into the task's working directory (members must stay
under it). Bundling stays with the reference's CLI.
"""
from __future__ import annotations

import io
import os
import tarfile
from typing import List


def extract(data: bytes, dest: str) -> List[str]:
    """Extract a context bundle; returns the extracted member names."""
    os.makedirs(dest, exist_ok=True)
    names: List[str] = []
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        for member in tar.getmembers():
            # path-traversal guard: members must stay under dest
            target = os.path.realpath(os.path.join(dest, member.name))
            if not target.startswith(os.path.realpath(dest) + os.sep):
                raise ValueError(f"unsafe path in context bundle: {member.name}")
            names.append(member.name)
        tar.extractall(dest, filter="data")
    return names
