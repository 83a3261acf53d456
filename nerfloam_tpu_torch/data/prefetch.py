"""Background scan prefetcher: overlap host IO/preprocessing with device work.

Copy of nerfloam_tpu/data/prefetch.py: the port imports nothing of the JAX
package.

The reference loads + segments each scan synchronously inside the tracking
loop (src/tracking.py:75 -> src/dataset/kitti.py:40-70, tens of ms of host
work serialized with GPU compute). Here a worker thread stays one-or-more
frames ahead: while the card optimizes frame k, the host reads, filters, and
ground-segments frame k+1. The port's file-based loaders filter and
segment in C++ (``nerfloam_tpu_torch/native``), whose ctypes calls release
the GIL, so the worker does not hold up the main thread's launches.
"""

from __future__ import annotations

import queue
import threading


class PrefetchingLoader:
    """Iterates (frame_id, dataset[frame_id]) for the given id sequence with
    a bounded lookahead queue."""

    def __init__(self, dataset, frame_ids, lookahead: int = 2):
        self.dataset = dataset
        self.frame_ids = list(frame_ids)
        self.q: queue.Queue = queue.Queue(maxsize=max(1, lookahead))
        self._err = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for fid in self.frame_ids:
                self.q.put((fid, self.dataset[fid]))
        except Exception as e:  # surface in the consumer
            self._err = e
        finally:
            self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                if self._err is not None:
                    raise self._err
                return
            yield item
