"""TensorBoard writer, the counterpart of ``tpureg/utils/tb.py``.

The reference writes scalars, scalar groups and image panels through
``torch.utils.tensorboard.SummaryWriter(flush_secs=30)`` (train.py:146,
inference.py:79-100). ``MetricWriter`` keeps that surface: it takes
``torch.utils.tensorboard``, else ``tensorboardX``, else becomes a no-op
with one warning on stderr, so that a run without either package knows it
writes nothing. The backend is imported when a writer is made, never when
this module is imported (``torch.utils.tensorboard`` pulls in TensorBoard,
which may pull in TensorFlow).
"""

from __future__ import annotations

import sys

import numpy as np

__all__ = ["MetricWriter"]


def _make_writer(logdir: str, flush_secs: int):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(logdir, flush_secs=flush_secs)
    except Exception:
        pass
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(logdir, flush_secs=flush_secs)
    except Exception:
        pass
    return None


class MetricWriter:
    def __init__(self, logdir: str, flush_secs: int = 30):
        self._w = _make_writer(logdir, flush_secs)
        if self._w is None:
            print(
                "WARNING: no TensorBoard backend available (neither "
                "torch.utils.tensorboard nor tensorboardX importable) — "
                f"metric logging to {logdir!r} is DISABLED for this run.",
                file=sys.stderr,
                flush=True,
            )

    @property
    def enabled(self) -> bool:
        return self._w is not None

    def add_scalar(self, tag, value, step):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def add_scalars(self, tag, values: dict, step):
        if self._w is not None:
            self._w.add_scalars(tag, {k: float(v) for k, v in values.items()},
                                step)

    def add_images(self, tag, images, step, dataformats: str = "NHWC"):
        """images: [N, H, W, C] float in [0, 1] or [N, C, H, W] uint8."""
        if self._w is None:
            return
        arr = np.asarray(images)
        if dataformats == "NHWC":
            arr = np.transpose(arr, (0, 3, 1, 2))
        self._w.add_images(tag, arr, step)

    def close(self):
        if self._w is not None:
            self._w.close()
