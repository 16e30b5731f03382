from .batch import TMPCStepResult, make_batched_tmpc_step, to_torch_fleet  # noqa: F401
