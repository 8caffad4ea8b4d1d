"""Quantum ESPRESSO files: the Fortran record reader.

Role of the file layer of the reference's qedat machinery
(src/grid3mod.f90:26-46; read_pwc src/grid3mod@proc.f90:734-852). The
port carries only `FortranFile`, which the bincube and pwc structure
readers need; the pwc grid with its Kohn-Sham states and the Wannier
functions wait for queue 1 item 4 of the roadmap.
"""
from __future__ import annotations

import numpy as np


class FortranFile:
    """Sequential Fortran unformatted records (4-byte length markers)."""

    def __init__(self, path, mode="rb"):
        self.fh = open(path, mode)

    def read_record(self, dtype=None, count=-1):
        head = self.fh.read(4)
        if len(head) < 4:
            raise EOFError("no more records")
        nbytes = int(np.frombuffer(head, np.int32)[0])
        raw = self.fh.read(nbytes)
        tail = self.fh.read(4)
        if len(tail) < 4 or int(np.frombuffer(tail, np.int32)[0]) != nbytes:
            raise ValueError("corrupt Fortran record")
        if dtype is None:
            return raw
        return np.frombuffer(raw, dtype=dtype, count=count)

    def write_record(self, *arrays):
        raw = b"".join(np.asarray(a).tobytes() for a in arrays)
        mark = np.int32(len(raw)).tobytes()
        self.fh.write(mark + raw + mark)

    def close(self):
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
