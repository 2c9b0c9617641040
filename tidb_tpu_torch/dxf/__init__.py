from tidb_tpu_torch.dxf.framework import (  # noqa: F401
    SubtaskState,
    TaskExecutor,
    TaskManager,
    TaskState,
    register_task_type,
)
