"""Weight download (`sodt_tpu/utils/downloads.py`): a --weights argument
that is a URL, or a path that does not exist, is fetched before loading.

A plain stdlib `urllib` fetch and an explicit source: the URL itself, a
`url` argument, or `SODT_WEIGHTS_BASE` (a base URL the file name is
joined to). Machines without network pass local paths; `file://` URLs
work offline. A URL is cached under `SODT_WEIGHTS_CACHE`, by default
`~/.cache/sodt_tpu/weights`, in a directory keyed by the URL's hash.
"""

from __future__ import annotations

import hashlib
import os
import urllib.parse
import urllib.request
from pathlib import Path

__all__ = ["attempt_download"]


def _fetch(url: str, dst: Path, min_bytes: int) -> None:
    # a per-process temporary name: concurrent fetchers of one file never
    # write into the same partial file
    tmp = dst.with_suffix(dst.suffix + f".{os.getpid()}.part")
    try:
        print(f"Downloading {url} to {dst}...")
        urllib.request.urlretrieve(url, tmp)  # noqa: S310 - explicit opt-in
        if tmp.stat().st_size < min_bytes:
            raise OSError(f"downloaded file too small "
                          f"({tmp.stat().st_size} B < {min_bytes} B)")
        tmp.replace(dst)
    finally:
        tmp.unlink(missing_ok=True)


def attempt_download(weights: str, url: str | None = None,
                     min_bytes: int = 100_000) -> str:
    """A local path for `weights`, downloading it where it is missing.

    `weights` a http(s) or file URL: fetched into the cache (a cached file
    below `min_bytes` is fetched again). A missing path: fetched from
    `url`, else from `SODT_WEIGHTS_BASE`/<name>, else returned unchanged
    (the loader then raises its own error). An existing path or "" is
    returned unchanged."""
    s = str(weights).strip()
    if urllib.parse.urlparse(s).scheme in ("http", "https", "file"):
        name = Path(urllib.parse.urlparse(s).path).name or "weights.ckpt"
        cache = Path(os.environ.get(
            "SODT_WEIGHTS_CACHE",
            Path.home() / ".cache" / "sodt_tpu" / "weights"))
        dst = cache / hashlib.sha256(s.encode()).hexdigest()[:16] / name
        if dst.exists() and dst.stat().st_size < min_bytes:
            dst.unlink()
        if not dst.exists():
            dst.parent.mkdir(parents=True, exist_ok=True)
            _fetch(s, dst, min_bytes)
        return str(dst)
    path = Path(s)
    if path.exists() or not s:
        return s
    src = url or (urllib.parse.urljoin(
        os.environ["SODT_WEIGHTS_BASE"].rstrip("/") + "/", path.name)
        if os.environ.get("SODT_WEIGHTS_BASE") else None)
    if src:
        path.parent.mkdir(parents=True, exist_ok=True)
        _fetch(src, path, min_bytes)
    return s
