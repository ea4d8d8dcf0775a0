"""File reading (counterpart of bem_tpu/utils/file_client.py): the disk
backend. lmdb and memcached are not ported and raise."""

from __future__ import annotations


class FileClient:
    """Bytes of a file by path, from the backend named in ``io_backend``
    (file_client.py:50)."""

    def __init__(self, backend: str = "disk", **kwargs):
        if backend in ("lmdb", "memcached"):
            raise NotImplementedError(f"the {backend} file backend is not ported (disk is)")
        if backend != "disk":
            raise ValueError(f"Backend {backend} is not supported. Supported: ['disk']")

    def get(self, filepath, client_key="default") -> bytes:
        with open(str(filepath), "rb") as f:
            return f.read()
