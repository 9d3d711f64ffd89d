"""Model artifact download: local paths and ``file://``.

Counterpart of ``seldon_core_tpu/storage.py`` for local stores. Remote
schemes (``gs://``, ``s3://``, azure blob, ``http(s)://``) are not ported
to this package yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from urllib.parse import urlparse

logger = logging.getLogger(__name__)


class Storage:
    @staticmethod
    def download(uri: str, out_dir: str | None = None) -> str:
        """Copy the artifact at ``uri`` into ``out_dir`` (a fresh
        temporary directory by default) and return that directory."""
        logger.info("Copying contents of %s to local", uri)
        scheme = urlparse(uri).scheme
        if scheme not in ("", "file"):
            raise NotImplementedError(
                f"storage scheme {scheme!r} ({uri}) is not ported to "
                "seldon_core_tpu_torch yet; use a local path or file://"
            )
        if out_dir is None:
            out_dir = tempfile.mkdtemp()
        return Storage._download_local(uri, out_dir)

    @staticmethod
    def _download_local(uri: str, out_dir: str) -> str:
        path = uri[len("file://"):] if uri.startswith("file://") else uri
        if not os.path.exists(path):
            raise RuntimeError(f"local path {path} does not exist")
        if os.path.isdir(path):
            for item in os.listdir(path):
                src = os.path.join(path, item)
                dst = os.path.join(out_dir, item)
                if os.path.isdir(src):
                    shutil.copytree(src, dst, dirs_exist_ok=True)
                else:
                    shutil.copy2(src, dst)
        else:
            shutil.copy2(path, out_dir)
        return out_dir
