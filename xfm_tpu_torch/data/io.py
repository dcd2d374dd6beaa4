"""Storage IO (`xfm_tpu/data/io.py`): one opener for local paths and
`hdfs://` (through the `hdfs dfs` command line, where it is installed),
under the names open_file / list_files / glob_files / exists / makedirs /
copy / count_lines.

`gs://` raises: the JAX package reaches it through tensorflow's gfile,
which the port does not import.
"""
from __future__ import annotations

import glob as _glob
import io
import os
import shutil
import subprocess
from contextlib import contextmanager
from typing import IO, Iterator


def _is_hdfs(path: str) -> bool:
    return path.startswith("hdfs://")


def _no_gcs(path: str) -> None:
    if path.startswith("gs://"):
        raise NotImplementedError(
            f"{path}: gs:// paths are not ported (the JAX package reads them "
            "through tensorflow); copy the files to a local or hdfs:// path")


def _hdfs_ls(pattern: str) -> list[str]:
    out = subprocess.run(f"hdfs dfs -ls {pattern}", shell=True,
                         capture_output=True, text=True).stdout
    return sorted(line.split()[-1] for line in out.splitlines()
                  if line.startswith("-") or line.startswith("d"))


@contextmanager
def open_file(path: str, mode: str = "r") -> Iterator[IO]:
    """Open a local or hdfs:// file; a local file opened for writing gets
    its directory made first."""
    _no_gcs(path)
    if _is_hdfs(path):
        if "r" in mode:
            proc = subprocess.Popen(f"hdfs dfs -text {path}", shell=True,
                                    stdout=subprocess.PIPE)
            try:
                yield (io.TextIOWrapper(proc.stdout) if "b" not in mode
                       else proc.stdout)
            finally:
                proc.stdout.close()
                proc.wait()
            return
        flag = "-appendToFile" if "a" in mode else "-put -f"
        proc = subprocess.Popen(f"hdfs dfs {flag} - {path}", shell=True,
                                stdin=subprocess.PIPE)
        try:
            yield (io.TextIOWrapper(proc.stdin) if "b" not in mode
                   else proc.stdin)
        finally:
            proc.stdin.close()
            proc.wait()
        return
    if "w" in mode or "a" in mode:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, mode) as f:
        yield f


def list_files(pattern: str) -> list[str]:
    """A path, glob or directory → its files, sorted; a path that matches
    no glob but exists → itself."""
    _no_gcs(pattern)
    if _is_hdfs(pattern):
        return _hdfs_ls(pattern)
    if os.path.isdir(pattern):
        return sorted(os.path.join(pattern, f) for f in os.listdir(pattern)
                      if os.path.isfile(os.path.join(pattern, f)))
    hits = sorted(_glob.glob(pattern))
    if hits:
        return hits
    return [pattern] if os.path.exists(pattern) else []


def glob_files(pattern: str) -> list[str]:
    """A glob's matches, sorted; [] where nothing matches."""
    _no_gcs(pattern)
    if _is_hdfs(pattern):
        return _hdfs_ls(pattern)
    return sorted(_glob.glob(pattern))


def exists(path: str) -> bool:
    _no_gcs(path)
    if _is_hdfs(path):
        return subprocess.run(f"hdfs dfs -test -e {path}",
                              shell=True).returncode == 0
    return os.path.exists(path)


def makedirs(path: str) -> None:
    _no_gcs(path)
    if _is_hdfs(path):
        subprocess.run(f"hdfs dfs -mkdir -p {path}", shell=True, check=False)
    else:
        os.makedirs(path, exist_ok=True)


def copy(src: str, dst: str) -> None:
    _no_gcs(src)
    _no_gcs(dst)
    if _is_hdfs(src) or _is_hdfs(dst):
        subprocess.run(f"hdfs dfs -cp -f {src} {dst}", shell=True,
                       check=False)
    else:
        shutil.copy(src, dst)


def count_lines(path: str) -> int:
    n = 0
    with open_file(path, "r") as f:
        for _ in f:
            n += 1
    return n
