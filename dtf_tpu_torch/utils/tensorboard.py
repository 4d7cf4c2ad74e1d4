"""TensorBoard scalar writer — event files from first principles (a
copy of ``dtf_tpu/utils/tensorboard.py``).

Parity with the reference's `--enable_tensorboard` →
`tf.keras.callbacks.TensorBoard(log_dir=model_dir)` (common.py:187-190),
without TensorFlow: an Event protobuf is hand-serialized (the wire
format is tiny — wall_time, step, Summary{tag, simple_value}) and
framed with the TFRecord framing records.py already owns.  Files are
readable by stock TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time

from dtf_tpu_torch.data.records import _len_delim, _varint, masked_crc32c


def _double_field(field: int, value: float) -> bytes:
    return _varint(field << 3 | 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _varint(field << 3 | 5) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _varint(field << 3 | 0) + _varint(value)


def _event(wall_time: float, step: int = 0, summary: bytes = b"",
           file_version: str = "") -> bytes:
    out = _double_field(1, wall_time) + _varint_field(2, step)
    if file_version:
        out += _len_delim(3, file_version.encode())
    if summary:
        out += _len_delim(5, summary)
    return out


class SummaryWriter:
    """Append-only scalar event writer for one log dir."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc32c(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        value_msg = _len_delim(1, tag.encode()) + _float_field(2, float(value))
        summary = _len_delim(1, value_msg)
        self._write(_event(time.time(), step=step, summary=summary))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TensorBoardCallback:
    """Writes per-epoch train metrics + eval results as scalars."""

    def __init__(self, model_dir: str):
        self.writer = SummaryWriter(os.path.join(model_dir, "train"))

    def on_epoch_end(self, epoch: int, logs=None):
        if not logs:
            return
        history = logs.get("history") or {}
        state = logs.get("state")
        step = int(state.step) if state is not None else epoch
        for key, series in history.items():
            if series:
                self.writer.scalar(f"epoch_{key}", series[-1], step)
        self.writer.flush()

    def on_train_end(self, logs=None):
        self.writer.close()
