"""PLANTED VIOLATIONS — unbounded_blocking.

Blocking queue/thread waits with no timeout inside thread-owning scopes:
a wedged peer thread turns each one into a silent forever-hang.
"""

import queue
import threading

from tpu_syncbn_torch.obs import flightrec


class WedgeableWorker:
    """Owns a collector thread: every unbounded wait here can hang the
    whole subsystem when the peer dies."""

    def __init__(self):
        self._q = queue.Queue(maxsize=4)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()  # bad: blocks forever if the producer died
            if item is None:
                return

    def submit(self, item):
        self._q.put(item)  # bad: full queue + dead consumer = forever

    def close(self):
        self._thread.join()  # bad: no timeout, no is_alive() check

    def recorder(self):
        return flightrec.get()  # ok: a module's accessor, not a queue


def consumer_loop(source):
    out_q = queue.Queue(maxsize=2)

    def produce():
        for item in source:
            out_q.put(item, timeout=0.1)  # ok: bounded

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    while True:
        item = out_q.get()  # bad: the producer may die without a sentinel
        if item is None:
            break
    t.join()  # bad: unbounded join on a possibly-wedged thread
