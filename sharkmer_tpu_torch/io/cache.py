"""Remote read cache with SHA-256 self-verification.

Reference: upstream sharkmer src/cache.rs. Semantics preserved:

* cache key = SHA-256 of the source URL; entry = ``{key}.fastq.gz``
  plus a ``{key}.meta.json`` sidecar {url, sha256, complete, n_reads}.
* every lookup re-verifies the payload SHA-256; corrupt or orphaned
  entries are evicted (self-healing).
* partial-vs-complete: an incomplete entry only hits when it holds at
  least the requested number of reads; complete entries always hit.
* downloads stream -> decompress -> truncate at max_reads ->
  recompress, then move into place atomically (tempfile + rename).
"""

from __future__ import annotations

import gzip
import hashlib
import json
import logging
import os
import shutil
import tempfile
import urllib.request
from dataclasses import dataclass
from pathlib import Path

log = logging.getLogger("sharkmer")


def default_cache_dir() -> Path:
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return Path(base) / "sharkmer"


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _url_key(url: str) -> str:
    return hashlib.sha256(url.encode()).hexdigest()


@dataclass
class CacheConfig:
    cache_dir: Path

    @classmethod
    def new(cls, cache_dir: str | os.PathLike | None = None) -> "CacheConfig":
        d = Path(cache_dir) if cache_dir else default_cache_dir()
        d.mkdir(parents=True, exist_ok=True)
        return cls(cache_dir=d)

    def _paths(self, url: str) -> tuple[Path, Path]:
        key = _url_key(url)
        return self.cache_dir / f"{key}.fastq.gz", self.cache_dir / f"{key}.meta.json"

    def lookup(self, url: str, max_reads: int) -> Path | None:
        """Return the cached path iff the entry is valid and sufficient."""
        data_path, meta_path = self._paths(url)
        if not data_path.exists() and not meta_path.exists():
            return None
        if not data_path.exists() or not meta_path.exists():
            log.warning("Evicting orphaned cache entry for %s", url)
            self._evict(url)
            return None
        try:
            meta = json.loads(meta_path.read_text())
        except (json.JSONDecodeError, OSError):
            log.warning("Evicting corrupt cache metadata for %s", url)
            self._evict(url)
            return None
        # re-verify content hash on every lookup (cache.rs:83-93)
        actual = _sha256_file(data_path)
        if actual != meta.get("sha256"):
            log.warning("Evicting corrupt cache entry for %s (checksum mismatch)", url)
            self._evict(url)
            return None
        # partial-vs-complete semantics (cache.rs:97-118)
        if meta.get("complete"):
            return data_path
        n_reads = int(meta.get("n_reads", 0))
        if max_reads > 0 and n_reads >= max_reads:
            return data_path
        log.info(
            "Cache entry for %s is incomplete (%d reads < requested); "
            "re-downloading", url, n_reads,
        )
        self._evict(url)
        return None

    def download_to_cache(self, url: str, max_reads: int) -> Path:
        """Stream the URL, truncate at max_reads, write atomically."""
        data_path, meta_path = self._paths(url)
        n_reads = 0
        complete = True

        with tempfile.NamedTemporaryFile(
            dir=self.cache_dir, suffix=".tmp.gz", delete=False
        ) as tmp:
            tmp_path = Path(tmp.name)
            try:
                req = urllib.request.Request(
                    url, headers={"User-Agent": "sharkmer-tpu"}
                )
                with urllib.request.urlopen(req, timeout=60) as resp:
                    src = gzip.GzipFile(fileobj=resp) if url.endswith(".gz") else resp
                    with gzip.GzipFile(fileobj=tmp, mode="wb") as out:
                        line_no = 0
                        while True:
                            line = src.readline()
                            if not line:
                                break
                            out.write(line)
                            line_no += 1
                            if line_no % 4 == 0:
                                n_reads += 1
                                if max_reads > 0 and n_reads >= max_reads:
                                    complete = False
                                    break
            except BaseException:
                tmp_path.unlink(missing_ok=True)
                raise

        sha = _sha256_file(tmp_path)
        os.replace(tmp_path, data_path)  # atomic within the cache dir
        meta = {
            "url": url,
            "sha256": sha,
            "complete": complete,
            "n_reads": n_reads,
        }
        tmp_meta = data_path.with_suffix(".meta.tmp")
        tmp_meta.write_text(json.dumps(meta))
        os.replace(tmp_meta, meta_path)
        log.info(
            "Cached %s (%d reads, %s)", url, n_reads,
            "complete" if complete else "truncated",
        )
        return data_path

    def _evict(self, url: str) -> None:
        data_path, meta_path = self._paths(url)
        data_path.unlink(missing_ok=True)
        meta_path.unlink(missing_ok=True)

    @staticmethod
    def clear(cache_dir: str | os.PathLike | None = None) -> None:
        d = Path(cache_dir) if cache_dir else default_cache_dir()
        if d.exists():
            shutil.rmtree(d)
