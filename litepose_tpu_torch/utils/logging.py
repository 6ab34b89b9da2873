"""Experiment logging and output directory layout (the port's copy of
``litepose_tpu/utils/logging.py``).

Mirrors the reference's logger/output conventions
(``lib/utils/utils.py:24-74``): per-run directory
``OUTPUT_DIR/<dataset>/<model>/<cfg_name>``, timestamped log files,
rank-aware console logging.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Tuple


def setup_logger(output_dir: str, rank: int = 0, phase: str = "train") -> logging.Logger:
    os.makedirs(output_dir, exist_ok=True)
    ts = time.strftime("%Y-%m-%d-%H-%M")
    log_file = os.path.join(output_dir, f"{phase}_{ts}_rank{rank}.log")
    logger = logging.getLogger(f"litepose_tpu_torch.{phase}")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):  # a second call replaces, and closes, the first's files
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)-15s %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    if rank == 0:
        ch = logging.StreamHandler()
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    return logger


def create_run_dirs(cfg, cfg_path: str, phase: str = "train") -> Tuple[str, str]:
    """(final_output_dir, tb_log_dir) following the reference layout."""
    root = Path(cfg.OUTPUT_DIR or "output")
    dataset = cfg.DATASET.DATASET
    model = cfg.MODEL.NAME
    cfg_name = Path(cfg_path).stem if cfg_path else "default"
    out = root / dataset / model / cfg_name
    out.mkdir(parents=True, exist_ok=True)
    tb = Path(cfg.LOG_DIR or "log") / dataset / model / (cfg_name + "_" + time.strftime("%Y-%m-%d-%H-%M"))
    tb.mkdir(parents=True, exist_ok=True)
    return str(out), str(tb)


def make_tb_writer(log_dir: str):
    """A tensorboardX ``SummaryWriter`` on ``log_dir``, or None when
    tensorboardX is not installed (logging then goes to the text log only)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


def print_name_value(logger, name_value: dict, full_arch_name: str = ""):
    """Markdown AP table (reference ``valid.py:77-94``)."""
    names = list(name_value.keys())
    values = list(name_value.values())
    logger.info("| Arch " + " ".join(f"| {n}" for n in names) + " |")
    logger.info("|---" * (len(names) + 1) + "|")
    logger.info(
        f"| {full_arch_name} "
        + " ".join(f"| {v:.3f}" for v in values)
        + " |"
    )
