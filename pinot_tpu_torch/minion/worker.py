"""The minion: polls the controller's task queue and runs the executors.

Counterpart of ``pinot_tpu/minion/worker.py`` (the reference's
BaseMinionStarter and TaskFactoryRegistry): the minion registers as a
MINION instance, claims WAITING tasks from the task manager, runs the
executor of each task's type (``minion/tasks.py``) and reports COMPLETED
or ERROR. ``run_one_task`` runs one task in the caller's thread;
``start`` polls on a thread of its own, which ``shutdown`` joins.
"""

from __future__ import annotations

import logging
import os
import threading

from typing import Dict, Optional

from pinot_tpu_torch.controller.state import InstanceInfo
from pinot_tpu_torch.controller.tasks import COMPLETED, ERROR, PinotTaskConfig
from pinot_tpu_torch.minion.tasks import (
    TASK_EXECUTORS,
    BaseTaskExecutor,
    MinionContext,
)

log = logging.getLogger(__name__)


class MinionInstance:
    """One minion worker; ``work_dir/<instance id>`` holds what its tasks
    build."""

    def __init__(self, instance_id: str, controller, work_dir: str,
                 executors: Optional[Dict[str, BaseTaskExecutor]] = None):
        self.instance_id = instance_id
        self.controller = controller
        self.ctx = MinionContext(controller=controller,
                                 work_dir=os.path.join(work_dir, instance_id))
        os.makedirs(self.ctx.work_dir, exist_ok=True)
        self.executors = dict(TASK_EXECUTORS if executors is None
                              else executors)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._counts_lock = threading.Lock()
        self.tasks_succeeded = 0  # guarded-by: _counts_lock
        self.tasks_failed = 0  # guarded-by: _counts_lock
        controller.store.register_instance(InstanceInfo(instance_id, "MINION"))

    # -- lifecycle -----------------------------------------------------------
    def start(self, poll_interval_s: float = 0.2) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.is_set():
                if not self.run_one_task():
                    self._stop.wait(poll_interval_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"minion-{self.instance_id}")
        self._thread.start()

    def shutdown(self) -> None:
        """Stop polling, join the thread (a task under way finishes
        first) and mark the instance dead."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        self.controller.store.set_instance_alive(self.instance_id, False)

    # -- work loop -----------------------------------------------------------
    def run_one_task(self) -> bool:
        """Claim and run one task; False when the queue held none."""
        task = self.controller.task_manager.poll(self.instance_id)
        if task is None:
            return False
        self._run(task)
        return True

    def _count(self, ok: bool) -> None:
        with self._counts_lock:
            if ok:
                self.tasks_succeeded += 1
            else:
                self.tasks_failed += 1

    def _run(self, task: PinotTaskConfig) -> None:
        executor = self.executors.get(task.task_type)
        tm = self.controller.task_manager
        if executor is None:
            tm.report(task.task_id, ERROR,
                      error=f"no executor for {task.task_type}")
            self._count(False)
            return
        try:
            outputs = executor.execute(task, self.ctx)
            tm.report(task.task_id, COMPLETED, output_segments=outputs)
            self._count(True)
        except Exception as exc:
            log.exception("task %s failed", task.task_id)
            tm.report(task.task_id, ERROR,
                      error=f"{type(exc).__name__}: {exc}")
            self._count(False)
