"""Dataset download helpers.

Counterpart of ``recbole_fairrec_tpu/utils/url.py``: an interactive confirm,
directory creation, a download that raises a clear error where the host has
no network, zip extraction and atomic-file renaming.
"""

from __future__ import annotations

import os
import zipfile
from logging import getLogger


def decide_download(url: str) -> bool:
    """Interactive confirmation before a large download."""
    d = input(f"This will download dataset from {url}. Will you proceed? (y/N)\n")
    return d.strip().lower() in ("y", "yes")


def makedirs(path: str) -> None:
    os.makedirs(os.path.expanduser(os.path.normpath(path)), exist_ok=True)


def download_url(url: str, folder: str):
    """Fetch ``url`` into ``folder`` (a file already there is kept). Raises
    a descriptive error when the host has no network access."""
    import urllib.error
    import urllib.request

    filename = url.rpartition("/")[2]
    path = os.path.join(folder, filename)
    if os.path.exists(path):
        getLogger().info("Using existing file %s", filename)
        return path
    makedirs(folder)
    try:
        urllib.request.urlretrieve(url, path)
    except (urllib.error.URLError, OSError) as e:
        raise RuntimeError(
            f"Could not download [{url}]; the host may have no network access. "
            "Place the atomic files under the dataset directory manually."
        ) from e
    return path


def extract_zip(path: str, folder: str) -> None:
    with zipfile.ZipFile(path, "r") as f:
        f.extractall(folder)


def rename_atomic_files(folder: str, old_name: str, new_name: str) -> None:
    """``<old>.<suffix>`` → ``<new>.<suffix>`` for every atomic file."""
    for item in os.listdir(folder):
        if not os.path.isfile(os.path.join(folder, item)):
            continue
        base, dot, suffix = item.rpartition(".")
        if base == old_name:
            os.rename(
                os.path.join(folder, item), os.path.join(folder, f"{new_name}.{suffix}")
            )
