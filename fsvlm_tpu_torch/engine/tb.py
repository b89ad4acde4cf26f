"""TensorBoard scalars (counterpart of fsvlm_tpu.engine.tb, the SummaryWriter
use of dassl/engine/trainer.py:225-240, 634-637).

One event file in TensorBoard's own format (``events.out.tfevents.*``: its
protobufs, framed by its RecordWriter), imported from the ``tensorboard``
package when a writer is made; the writer does nothing when that import
fails (no ``tensorboard``, as on the card's machine), as the JAX package's
does without tensorflow.  Not ``torch.utils.tensorboard``: its writer
resolves TensorBoard's TensorFlow shim, which imports tensorflow where that
is installed, and tensorflow imports jax (the port imports none of it);
forcing the shim's stub instead breaks every later tensorflow import in
the process.
"""

import os
import socket
import time


class TensorboardWriter:
    def __init__(self, log_dir):
        self._writer = None
        try:
            from tensorboard.compat.proto import event_pb2, summary_pb2
            from tensorboard.summary.writer.record_writer import RecordWriter
        except ImportError:
            return
        self._event, self._summary = event_pb2.Event, summary_pb2.Summary
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}.{os.getpid()}"
        self._writer = RecordWriter(open(os.path.join(log_dir, name), "wb"))
        self._write(self._event(wall_time=time.time(), file_version="brain.Event:2"))
        print(f"Initialize tensorboard (log_dir={log_dir})")

    def _write(self, event):
        self._writer.write(event.SerializeToString())

    def scalar(self, tag, value, step):
        if self._writer is not None:
            value = self._summary.Value(tag=tag, simple_value=float(value))
            self._write(self._event(wall_time=time.time(), step=int(step),
                                    summary=self._summary(value=[value])))

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def __bool__(self):
        return self._writer is not None
