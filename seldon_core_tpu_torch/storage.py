"""Model artifact download: file://, gs://, s3://, azure blob, http(s)://.

Counterpart of ``seldon_core_tpu/storage.py`` (reference:
python/seldon_core/storage.py:25-160: GCS/S3/Azure/file pulls into a
local directory that the prepackaged servers read; azure URIs are
``https://<account>.blob.core.windows.net/<container>/<path>``). The
cloud branches get their client from an injectable factory
(``Storage.set_client_factory``): by default the real SDK's client,
built lazily; tests inject fakes, so every branch runs without a
network. A missing SDK raises a clear error naming it. A local
directory (a path or ``file://``) is read where it is unless ``out_dir``
asks for a copy; a local file is copied into a directory, as every
caller joins its file name onto the result. Object listings
are string-prefix matches, so a key outside the prefix "directory"
(``models/iris2/x`` under ``models/iris``) is skipped and never written
outside the output directory.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from typing import Callable, Dict, Optional
from urllib.parse import urlparse

logger = logging.getLogger(__name__)

_AZURE_HOST_SUFFIX = ".blob.core.windows.net"


class Storage:
    # kind -> zero/one-arg factory returning a cloud client; tests inject
    # fakes here, production lazily builds the real SDK client
    _client_factories: Dict[str, Optional[Callable]] = {
        "gcs": None,
        "s3": None,
        "azure": None,
    }

    @classmethod
    def set_client_factory(cls, kind: str, factory: Optional[Callable]) -> None:
        if kind not in cls._client_factories:
            raise ValueError(f"unknown storage kind {kind!r}")
        cls._client_factories[kind] = factory

    @staticmethod
    def download(uri: str, out_dir: str | None = None) -> str:
        """A local directory holding the artifact at ``uri``. A remote
        artifact or a local file is copied into ``out_dir`` (a fresh
        temporary directory by default). A local directory is copied only
        when ``out_dir`` is given, else read where it is, as the reference
        does (the JAX package copies it on every load)."""
        logger.info("Copying contents of %s to local", uri)
        parsed = urlparse(uri)
        scheme = parsed.scheme
        if scheme in ("", "file"):
            return Storage._download_local(uri, out_dir)
        if scheme not in ("gs", "s3", "http", "https"):
            raise ValueError(
                f"cannot recognize storage type for {uri}; supported: file://, "
                f"gs://, s3://, https://*{_AZURE_HOST_SUFFIX}/..., http(s)://"
            )
        if out_dir is None:
            out_dir = tempfile.mkdtemp()
        if scheme == "gs":
            return Storage._download_gcs(uri, out_dir)
        if scheme == "s3":
            return Storage._download_s3(uri, out_dir)
        if parsed.netloc.endswith(_AZURE_HOST_SUFFIX):
            return Storage._download_azure(uri, out_dir)
        return Storage._download_http(uri, out_dir)

    @staticmethod
    def _download_local(uri: str, out_dir: Optional[str]) -> str:
        path = uri[len("file://"):] if uri.startswith("file://") else uri
        if not os.path.exists(path):
            raise RuntimeError(f"local path {path} does not exist")
        if os.path.isdir(path) and out_dir is None:
            return path
        if out_dir is None:
            out_dir = tempfile.mkdtemp()
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

    @staticmethod
    def _under_prefix(key: str, prefix: str) -> bool:
        """True when key is the prefix object itself or inside the prefix
        "directory". Listings are STRING-prefix matches, so without this a
        sibling like models/iris2/x would match prefix models/iris and its
        relpath would escape out_dir via '..'."""
        if not prefix or prefix.endswith("/"):
            return True
        return key == prefix or key.startswith(prefix + "/")

    @staticmethod
    def _dst_path(out_dir: str, key: str, prefix: str) -> str:
        rel = os.path.relpath(key, prefix)
        if rel.startswith(".."):
            raise RuntimeError(f"object key {key!r} escapes prefix {prefix!r}")
        dst = os.path.join(out_dir, rel if rel != "." else os.path.basename(key))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        return dst

    @staticmethod
    def _gcs_client():
        factory = Storage._client_factories["gcs"]
        if factory is not None:
            return factory()
        try:
            from google.cloud import storage as gcs  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "gs:// model URIs need google-cloud-storage, which is not installed"
            ) from e
        return gcs.Client()

    @staticmethod
    def _download_gcs(uri: str, out_dir: str) -> str:
        parsed = urlparse(uri)
        client = Storage._gcs_client()
        bucket = client.bucket(parsed.netloc)
        prefix = parsed.path.lstrip("/")
        blobs = [
            b for b in bucket.list_blobs(prefix=prefix)
            if Storage._under_prefix(b.name, prefix)
        ]
        if not blobs:
            raise RuntimeError(f"no objects under {uri}")
        for blob in blobs:
            blob.download_to_filename(Storage._dst_path(out_dir, blob.name, prefix))
        return out_dir

    @staticmethod
    def _s3_client():
        factory = Storage._client_factories["s3"]
        if factory is not None:
            return factory()
        try:
            import boto3  # type: ignore
        except ImportError as e:
            raise RuntimeError("s3:// model URIs need boto3, which is not installed") from e
        return boto3.client("s3", endpoint_url=os.environ.get("S3_ENDPOINT") or None)

    @staticmethod
    def _download_s3(uri: str, out_dir: str) -> str:
        parsed = urlparse(uri)
        s3 = Storage._s3_client()
        prefix = parsed.path.lstrip("/")
        paginator = s3.get_paginator("list_objects_v2")
        n = 0
        for page in paginator.paginate(Bucket=parsed.netloc, Prefix=prefix):
            for obj in page.get("Contents", []):
                if not Storage._under_prefix(obj["Key"], prefix):
                    continue
                s3.download_file(
                    parsed.netloc, obj["Key"],
                    Storage._dst_path(out_dir, obj["Key"], prefix),
                )
                n += 1
        if n == 0:
            raise RuntimeError(f"no objects under {uri}")
        return out_dir

    @staticmethod
    def _azure_client(account_url: str):
        factory = Storage._client_factories["azure"]
        if factory is not None:
            return factory(account_url)
        try:
            from azure.storage.blob import BlobServiceClient  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "azure blob model URIs need azure-storage-blob, which is not installed"
            ) from e
        return BlobServiceClient(account_url=account_url)

    @staticmethod
    def _download_azure(uri: str, out_dir: str) -> str:
        """https://<account>.blob.core.windows.net/<container>/<prefix>
        (reference: python/seldon_core/storage.py:25-65 azure handling)."""
        parsed = urlparse(uri)
        parts = parsed.path.lstrip("/").split("/", 1)
        container = parts[0]
        prefix = parts[1] if len(parts) > 1 else ""
        if not container:
            raise ValueError(f"azure URI {uri} has no container")
        service = Storage._azure_client(f"{parsed.scheme}://{parsed.netloc}")
        container_client = service.get_container_client(container)
        blobs = [
            b for b in container_client.list_blobs(name_starts_with=prefix)
            if Storage._under_prefix(getattr(b, "name", None) or b["name"], prefix)
        ]
        if not blobs:
            raise RuntimeError(f"no objects under {uri}")
        for blob in blobs:
            name = getattr(blob, "name", None) or blob["name"]
            dst = Storage._dst_path(out_dir, name, prefix)
            with open(dst, "wb") as f:
                f.write(container_client.download_blob(name).readall())
        return out_dir

    @staticmethod
    def _download_http(uri: str, out_dir: str) -> str:
        import urllib.request

        dst = os.path.join(out_dir, os.path.basename(urlparse(uri).path) or "artifact")
        with urllib.request.urlopen(uri) as r, open(dst, "wb") as f:
            shutil.copyfileobj(r, f)
        return out_dir
