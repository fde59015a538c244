"""The warm-start layer: the kernel-library store and the runtime that
serves the libraries from it.

See aot/store.py (the on-disk store) and aot/runtime.py (the runtime
utils/torchtools.load_library consults). Offline builder:
cmd/aot_build.py; cross-process check: cmd/aot_smoke.py; process wiring:
cmd/scheduler.py and cmd/trace_replay.py `--aot-store`.
"""
from yunikorn_tpu_torch.aot.runtime import (  # noqa: F401
    BACKGROUND_REFUSED,
    AotRuntime,
    active,
    compile_count,
    get_runtime,
    install,
    namespace,
    set_runtime,
)
from yunikorn_tpu_torch.aot.store import AotStore  # noqa: F401
