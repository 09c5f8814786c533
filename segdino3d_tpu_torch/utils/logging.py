"""Logging and run provenance.

Counterpart of ``segdino3d_tpu/utils/logging.py``: process 0 logs to
stdout, every process to ``work_dir/log_{proc}/log.txt``; each run records
the git SHA and a zip of the port's package and ``configs/``.
"""
from __future__ import annotations

import logging
import os
import subprocess
import sys
import zipfile


def setup_logger(work_dir: str = None, name: str = "segdino3d_tpu_torch",
                 process_index: int = 0) -> logging.Logger:
    """The logger ``name`` with its handlers replaced: stdout on process
    0, ``work_dir/log_{process_index}/log.txt`` with a ``work_dir``."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter(
        "[%(asctime)s %(name)s %(levelname)s] %(message)s",
        datefmt="%m/%d %H:%M:%S")
    if process_index == 0:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if work_dir:
        log_dir = os.path.join(work_dir, f"log_{process_index}")
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def get_git_sha(repo_dir: str = None) -> str:
    repo_dir = repo_dir or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    try:
        sha = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=repo_dir,
            stderr=subprocess.DEVNULL).decode().strip()
        dirty = subprocess.call(
            ["git", "diff-index", "--quiet", "HEAD"], cwd=repo_dir,
            stderr=subprocess.DEVNULL) != 0
        return sha + (" (dirty)" if dirty else "")
    except Exception:
        return "unknown"


def dump_code(work_dir: str, repo_dir: str = None,
              dirs=("segdino3d_tpu_torch", "configs")):
    """Zip the git-tracked files under ``dirs`` into
    ``work_dir/code_dump.zip``."""
    repo_dir = repo_dir or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    try:
        files = subprocess.check_output(
            ["git", "ls-files", "--", *dirs], cwd=repo_dir,
            stderr=subprocess.DEVNULL).decode().splitlines()
    except Exception:
        return
    os.makedirs(work_dir, exist_ok=True)
    with zipfile.ZipFile(os.path.join(work_dir, "code_dump.zip"), "w",
                         zipfile.ZIP_DEFLATED) as zf:
        for f in files:
            p = os.path.join(repo_dir, f)
            if os.path.isfile(p):
                zf.write(p, f)
