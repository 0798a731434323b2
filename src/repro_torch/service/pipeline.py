# Copied from repro/service/pipeline.py; imports renamed.
"""Stage-level pipeline parallelism (paper Fig. 3c).

A ``StagePipeline`` chains stages through bounded queues, one worker thread
per stage, so download / pre-process / AL-inference overlap instead of
running serially per round (Fig. 3a/b). Per-stage busy and wait times are
recorded — the Table-2 benchmark derives its pipeline-vs-serial comparison
from exactly these counters.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Iterable, List, Optional, Sequence

_SENTINEL = object()


@dataclasses.dataclass
class StageStats:
    name: str
    items: int = 0
    busy_s: float = 0.0
    wait_s: float = 0.0

    def as_dict(self):
        return dataclasses.asdict(self)


class Stage:
    def __init__(self, name: str, fn: Callable[[Any], Any]):
        self.name = name
        self.fn = fn
        self.stats = StageStats(name)


class StagePipeline:
    """run(items): push items through all stages with overlap."""

    def __init__(self, stages: Sequence[Stage], max_queue: int = 8):
        self.stages = list(stages)
        self.max_queue = max_queue

    def run(self, items: Iterable[Any]) -> List[Any]:
        qs = [queue.Queue(maxsize=self.max_queue)
              for _ in range(len(self.stages) + 1)]
        out: List[Any] = []
        errors: List[BaseException] = []
        # A mid-stage exception must tear the WHOLE pipeline down: stages
        # upstream of the failed one would otherwise block forever on their
        # bounded output queue (the dead stage no longer drains it) and
        # join() would deadlock. Every blocking put/get is therefore a
        # short-timeout poll that aborts once the flag is set.
        abort = threading.Event()

        def put(q: queue.Queue, item) -> bool:
            while not abort.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def get(q: queue.Queue):
            while not abort.is_set():
                try:
                    return q.get(timeout=0.05)
                except queue.Empty:
                    continue
            return _SENTINEL

        def worker(stage: Stage, qin: queue.Queue, qout: queue.Queue):
            while True:
                t0 = time.perf_counter()
                item = get(qin)
                stage.stats.wait_s += time.perf_counter() - t0
                if item is _SENTINEL:
                    put(qout, _SENTINEL)
                    return
                t0 = time.perf_counter()
                try:
                    res = stage.fn(item)
                except BaseException as e:  # propagate to caller
                    errors.append(e)
                    abort.set()
                    put(qout, _SENTINEL)
                    return
                stage.stats.busy_s += time.perf_counter() - t0
                stage.stats.items += 1
                if not put(qout, res):
                    return
                if abort.is_set():
                    return

        threads = [
            threading.Thread(target=worker, args=(s, qs[i], qs[i + 1]),
                             daemon=True)
            for i, s in enumerate(self.stages)
        ]
        for t in threads:
            t.start()

        def feeder():
            # the items iterable itself may raise (lazy loaders): that must
            # abort the pipeline like a stage error, not strand the workers
            try:
                for it in items:
                    if not put(qs[0], it):
                        return
            except BaseException as e:
                errors.append(e)
                abort.set()
                return
            put(qs[0], _SENTINEL)

        tf = threading.Thread(target=feeder, daemon=True)
        tf.start()
        while True:
            item = get(qs[-1])
            if item is _SENTINEL:
                break
            out.append(item)
        abort_was_set = abort.is_set()
        abort.set()        # release any worker still parked on a full queue
        for t in threads:
            t.join()
        tf.join()
        if errors:
            raise errors[0]
        if abort_was_set:  # aborted without a recorded error (defensive)
            raise RuntimeError("pipeline aborted")
        return out

    def run_serial(self, items: Iterable[Any]) -> List[Any]:
        """Paper Fig. 3a baseline: stages strictly one after another."""
        out = []
        for item in items:
            for s in self.stages:
                t0 = time.perf_counter()
                item = s.fn(item)
                s.stats.busy_s += time.perf_counter() - t0
                s.stats.items += 1
            out.append(item)
        return out

    def stats(self):
        return [s.stats.as_dict() for s in self.stages]
