"""Host-side data prefetching (the JAX package's ``data/prefetch.py``).

The reference used torch DataLoader worker processes
(``meta_datamodule.py:36-45``, num_workers=4); here collation is cheap numpy
work, so one producer thread with a small queue hides it behind the card's
work.  The thread yields CPU tensors; the training step moves them to the
card in the main thread.
"""

import queue
import threading


class Prefetcher:
    """Wrap a (possibly infinite) generator with a producer thread."""

    _SENTINEL = object()

    def __init__(self, gen, depth=2):
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()

        def worker():
            try:
                for item in gen:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except Exception as e:  # surfaced on next()
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the producer: it ends after the item it is collating."""
        self._stop.set()
        # drain so the producer can leave a blocked put
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
