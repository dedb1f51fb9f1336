"""PLANTED VIOLATIONS — unlocked_shared_state.

In a lock-owning class, shared containers and counters mutated outside
``with self.<lock>:`` (a torn update under a second thread is a
heisenbug, not a test failure).
"""

import threading


class Batcher:
    def __init__(self):
        self._lock = threading.Lock()
        self._queue = []
        self._pending = {}
        self._errors: list = []  # AnnAssign container: tracked too
        self._inflight = 0  # shared counter: += is read-modify-write

    def submit(self, item):
        self._queue.append(item)  # bad: no lock held
        self._inflight += 1  # bad: non-atomic counter bump, no lock

    def settle(self, key):
        self._pending[key] = True  # bad: subscript store, no lock

    def record_error(self, e):
        self._errors.append(e)  # bad: AnnAssign-declared container

    def _bump_anywhere(self):
        self._inflight += 1  # bad: one of its callers holds no lock

    def locked_caller(self):
        with self._lock:
            self._bump_anywhere()

    def unlocked_caller(self):
        self._bump_anywhere()

    def _bump_locked(self):
        self._inflight += 1  # ok: every caller holds the lock

    def locked_submit(self, item):
        with self._lock:
            self._queue.append(item)  # ok: under the lock
            self._bump_locked()
