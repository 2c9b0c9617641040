"""DXF: distributed execution framework for background jobs.

Counterpart of tidb_tpu/dxf/framework.py: the manager's lock is a
``dxf.manager`` class of utils/racecheck.py, and the ``dxf/submit`` and
``dxf/heartbeat`` failpoints fire where the JAX package's do.

Reference: pkg/disttask/framework — a Scheduler (on the owner node)
advances task state machines and dispatches subtasks; TaskExecutors on
every node claim subtasks, heartbeat, and run them; states live in the
system tables mysql.tidb_global_task / tidb_background_subtask
(framework/storage), so tasks survive node loss and subtasks rebalance
to healthy executors (proto/task.go:44 states, proto/step.go steps).

TPU-native shape: the "nodes" are executor workers over the shared
catalog (the same modeling move unistore makes for TiKV — in-process,
same contracts). Task/subtask rows persist in mysql.* system tables in
the catalog, so a new TaskManager over the same (possibly reloaded)
catalog resumes unfinished tasks: steps are idempotent, matching
proto/step.go:70-72.

Task types plug in via register_task_type(name, planner, runner,
finalizer):
  planner(task_meta, catalog) -> [subtask_meta, ...]  (split the job)
  runner(subtask_meta, catalog) -> result dict        (do one shard)
  finalizer(task_meta, [results], catalog) -> None    (merge/commit)
"""

from __future__ import annotations

import enum
import json
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from tidb_tpu_torch.dtypes import FLOAT64, STRING
from tidb_tpu_torch.storage.table import TableSchema
from tidb_tpu_torch.utils import racecheck
from tidb_tpu_torch.utils.failpoint import inject


class TaskState(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    SUCCEED = "succeed"
    FAILED = "failed"
    REVERTING = "reverting"
    REVERTED = "reverted"


class SubtaskState(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    SUCCEED = "succeed"
    FAILED = "failed"


_TASK_TYPES: Dict[str, Dict[str, Callable]] = {}


def register_task_type(name, planner, runner, finalizer=None, reverter=None):
    _TASK_TYPES[name] = {
        "planner": planner,
        "runner": runner,
        "finalizer": finalizer,
        "reverter": reverter,
    }


#: executor heartbeats older than this are dead; their subtasks rebalance
HEARTBEAT_TTL_S = 5.0


def fence_accepts(owner, state, reporter, running_state) -> bool:
    """The subtask-ledger idempotence fence (reference: framework/storage
    subtask state + exec id): a completion report lands iff it comes
    from the CURRENT owner of the work while the work is still in
    flight. Late reports from superseded owners (rebalanced / DCN
    re-dispatched work) and duplicate redeliveries of already-landed
    work are dropped, so every result is incorporated exactly once."""
    if reporter is not None and owner != reporter:
        return False
    return state == running_state


class TaskManager:
    """Owner-side state store + scheduler loop over the system tables.

    One manager per process is the analog of the DXF owner; its
    executors (below) are threads of the process."""

    def __init__(self, catalog):
        self.catalog = catalog
        self._lock = racecheck.make_lock("dxf.manager")
        self._ensure_tables()
        self._load()

    # -- system-table persistence --------------------------------------
    def _ensure_tables(self):
        self.catalog.create_database("mysql", if_not_exists=True)
        if not self.catalog.has_table("mysql", "tidb_global_task"):
            self.catalog.create_table(
                "mysql", "tidb_global_task",
                TableSchema([
                    ("id", STRING), ("type", STRING), ("state", STRING),
                    ("meta", STRING), ("error", STRING),
                ]),
            )
        if not self.catalog.has_table("mysql", "tidb_background_subtask"):
            self.catalog.create_table(
                "mysql", "tidb_background_subtask",
                TableSchema([
                    ("id", STRING), ("task_id", STRING), ("state", STRING),
                    ("executor_id", STRING), ("meta", STRING),
                    ("result", STRING), ("heartbeat", FLOAT64),
                ]),
            )

    def _load(self):
        """Rehydrate in-memory views from the system tables (resume)."""
        self.tasks: Dict[str, dict] = {}
        self.subtasks: Dict[str, dict] = {}
        for row in self._rows("tidb_global_task"):
            self.tasks[row["id"]] = row
        for row in self._rows("tidb_background_subtask"):
            self.subtasks[row["id"]] = row
        # a manager restart is an owner failover: anything RUNNING is
        # picked up again; orphaned running subtasks go back to pending
        for st in self.subtasks.values():
            if st["state"] == SubtaskState.RUNNING.value:
                st["state"] = SubtaskState.PENDING.value
                st["executor_id"] = ""
        self._persist()

    def _rows(self, name) -> List[dict]:
        t = self.catalog.table("mysql", name)
        cols = t.schema.names
        out = []
        for b in t.blocks():
            decoded = {n: b.columns[n].decode() for n in cols}
            for i in range(b.nrows):
                out.append({n: decoded[n][i] for n in cols})
        return out

    def _persist(self):
        """Rewrite both system tables from the in-memory views (small
        tables; the whole-state write IS the checkpoint). A state equal to
        the one last written is not written again: the scheduler ticks
        every 50 ms, and each rewrite is two versions of each table."""
        snap = (tuple(tuple(v.items()) for v in self.tasks.values()),
                tuple(tuple(v.items()) for v in self.subtasks.values()))
        if snap == getattr(self, "_written", None):
            return
        self._written = snap
        t = self.catalog.table("mysql", "tidb_global_task")
        t.replace_blocks([], modified_rows=0)
        rows = [
            [v["id"], v["type"], v["state"], v["meta"], v.get("error") or ""]
            for v in self.tasks.values()
        ]
        if rows:
            t.append_rows(rows)
        st = self.catalog.table("mysql", "tidb_background_subtask")
        st.replace_blocks([], modified_rows=0)
        rows = [
            [
                v["id"], v["task_id"], v["state"], v.get("executor_id") or "",
                v["meta"], v.get("result") or "", float(v.get("heartbeat") or 0),
            ]
            for v in self.subtasks.values()
        ]
        if rows:
            st.append_rows(rows)

    # -- task submission ----------------------------------------------
    def submit(self, task_type: str, meta: dict) -> str:
        inject("dxf/submit")
        if task_type not in _TASK_TYPES:
            raise ValueError(f"unknown task type {task_type!r}")
        tid = uuid.uuid4().hex[:12]
        with self._lock:
            self.tasks[tid] = {
                "id": tid, "type": task_type,
                "state": TaskState.PENDING.value,
                "meta": json.dumps(meta), "error": "",
            }
            self._persist()
        return tid

    def task_state(self, tid: str) -> Optional[str]:
        t = self.tasks.get(tid)
        return t["state"] if t else None

    # -- scheduler -----------------------------------------------------
    def schedule_once(self) -> None:
        """One owner tick: plan pending tasks, rebalance dead executors'
        subtasks, finalize tasks whose subtasks all succeeded."""
        with self._lock:
            now = time.monotonic()
            for task in list(self.tasks.values()):
                tt = _TASK_TYPES.get(task["type"])
                if tt is None:
                    continue
                if task["state"] == TaskState.PENDING.value:
                    meta = json.loads(task["meta"])
                    try:
                        metas = tt["planner"](meta, self.catalog)
                        # what the planner set in the task's meta (a
                        # nonce for its spill files) reaches the finalizer
                        # and the reverter
                        task["meta"] = json.dumps(meta)
                    except Exception as e:
                        # a bad task must not crash the scheduler tick
                        # (and stall every other task)
                        task["state"] = TaskState.FAILED.value
                        task["error"] = f"planner: {e!r}"
                        continue
                    if not metas:
                        # nothing to do (e.g. empty import file): the
                        # task is trivially done — finalize with no
                        # results rather than hanging in RUNNING
                        try:
                            if tt["finalizer"] is not None:
                                tt["finalizer"](
                                    json.loads(task["meta"]), [], self.catalog
                                )
                            task["state"] = TaskState.SUCCEED.value
                        except Exception as e:
                            task["state"] = TaskState.FAILED.value
                            task["error"] = str(e)
                        continue
                    for m in metas:
                        sid = uuid.uuid4().hex[:12]
                        self.subtasks[sid] = {
                            "id": sid, "task_id": task["id"],
                            "state": SubtaskState.PENDING.value,
                            "executor_id": "", "meta": json.dumps(m),
                            "result": "", "heartbeat": 0.0,
                        }
                    task["state"] = TaskState.RUNNING.value
                elif task["state"] == TaskState.RUNNING.value:
                    subs = [
                        s for s in self.subtasks.values()
                        if s["task_id"] == task["id"]
                    ]
                    # rebalance: running subtask whose executor went
                    # silent goes back to the pool (scheduler-side
                    # failure detection, framework/scheduler)
                    for s in subs:
                        if (
                            s["state"] == SubtaskState.RUNNING.value
                            and now - float(s["heartbeat"] or 0) > HEARTBEAT_TTL_S
                        ):
                            s["state"] = SubtaskState.PENDING.value
                            s["executor_id"] = ""
                    if any(s["state"] == SubtaskState.FAILED.value for s in subs):
                        task["state"] = TaskState.REVERTING.value
                        task["error"] = next(
                            s["result"] for s in subs
                            if s["state"] == SubtaskState.FAILED.value
                        )
                    elif subs and all(
                        s["state"] == SubtaskState.SUCCEED.value for s in subs
                    ):
                        try:
                            if tt["finalizer"] is not None:
                                tt["finalizer"](
                                    json.loads(task["meta"]),
                                    [json.loads(s["result"]) for s in subs],
                                    self.catalog,
                                )
                            task["state"] = TaskState.SUCCEED.value
                        except Exception as e:
                            task["state"] = TaskState.FAILED.value
                            task["error"] = str(e)
                elif task["state"] == TaskState.REVERTING.value:
                    try:
                        if tt["reverter"] is not None:
                            tt["reverter"](json.loads(task["meta"]), self.catalog)
                            task["state"] = TaskState.REVERTED.value
                        else:
                            task["state"] = TaskState.FAILED.value
                    except Exception:
                        task["state"] = TaskState.FAILED.value
            self._persist()

    # -- executor API --------------------------------------------------
    def claim_subtask(self, executor_id: str) -> Optional[dict]:
        with self._lock:
            for s in self.subtasks.values():
                if s["state"] == SubtaskState.PENDING.value:
                    task = self.tasks.get(s["task_id"])
                    if task is None or task["state"] != TaskState.RUNNING.value:
                        continue
                    s["state"] = SubtaskState.RUNNING.value
                    s["executor_id"] = executor_id
                    s["heartbeat"] = time.monotonic()
                    self._persist()
                    return dict(s)
        return None

    def heartbeat(self, subtask_id: str) -> None:
        inject("dxf/heartbeat")
        with self._lock:
            s = self.subtasks.get(subtask_id)
            if s is not None:
                s["heartbeat"] = time.monotonic()

    def finish_subtask(
        self, subtask_id: str, result: dict, failed=False,
        executor_id: Optional[str] = None,
    ) -> None:
        with self._lock:
            s = self.subtasks.get(subtask_id)
            if s is None:
                return
            # fencing: a subtask rebalanced away from a silent executor
            # must not accept that executor's late report (otherwise the
            # work lands twice — the reference fences via subtask state
            # + exec id in framework/storage)
            if executor_id is not None and not fence_accepts(
                s.get("executor_id"), s["state"],
                executor_id, SubtaskState.RUNNING.value,
            ):
                return
            s["state"] = (
                SubtaskState.FAILED.value if failed else SubtaskState.SUCCEED.value
            )
            s["result"] = json.dumps(result) if not failed else str(result)
            self._persist()

    def run_to_completion(
        self, tid: str, executors: int = 2, timeout_s: float = 120.0
    ) -> str:
        """Convenience driver: spin up N executors, tick the scheduler
        until the task reaches a terminal state."""
        execs = [TaskExecutor(self, f"exec-{i}") for i in range(executors)]
        for e in execs:
            e.start()
        try:
            t0 = time.monotonic()
            while time.monotonic() - t0 < timeout_s:
                self.schedule_once()
                st = self.task_state(tid)
                if st in (
                    TaskState.SUCCEED.value, TaskState.FAILED.value,
                    TaskState.REVERTED.value,
                ):
                    return st
                time.sleep(0.05)
            raise TimeoutError(f"task {tid} did not finish")
        finally:
            for e in execs:
                e.stop()


class TaskExecutor:
    """Worker node: claims pending subtasks, heartbeats, runs them.
    Reference: framework/taskexecutor (poll -> claim -> run -> report)."""

    def __init__(self, manager: TaskManager, executor_id: str):
        self.manager = manager
        self.executor_id = executor_id
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run_one(self) -> bool:
        """Claim and run a single subtask; returns False when none.
        A ticker refreshes the heartbeat while the runner executes so
        long subtasks aren't falsely rebalanced."""
        s = self.manager.claim_subtask(self.executor_id)
        if s is None:
            return False
        task = self.manager.tasks[s["task_id"]]
        tt = _TASK_TYPES[task["type"]]
        hb_stop = threading.Event()

        def beat():
            while not hb_stop.wait(HEARTBEAT_TTL_S / 2):
                self.manager.heartbeat(s["id"])

        hb = threading.Thread(
            target=beat, daemon=True, name=f"dxf-heartbeat-{s['id']}"
        )
        hb.start()
        try:
            result = tt["runner"](json.loads(s["meta"]), self.manager.catalog)
            self.manager.finish_subtask(
                s["id"], result or {}, executor_id=self.executor_id
            )
        except Exception as e:
            self.manager.finish_subtask(
                s["id"], repr(e), failed=True, executor_id=self.executor_id
            )
        finally:
            hb_stop.set()
            hb.join(timeout=1)
        return True

    def start(self) -> None:
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if not self.run_one():
                    self._stop.wait(0.05)

        self._thread = threading.Thread(
            target=loop, name=f"dxf-{self.executor_id}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
