"""graftchaos — repo-native fault injection (see chaos/inject.py).

Import as ``from elasticdl_tpu_torch import chaos`` and call the module helpers;
hot-path call sites use ``chaos.hook(...)`` only (the no-op-when-disabled
API the ``chaos-discipline`` lint rule enforces).
"""

from elasticdl_tpu_torch.chaos.inject import (  # noqa: F401
    CHAOS_KILL_EXIT_CODE,
    ChaosError,
    ChaosFault,
    ChaosInjector,
    ChaosRpcDropped,
    configure,
    default,
    enabled,
    hook,
    parse_plan,
    set_context,
)
