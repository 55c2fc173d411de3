"""The port's analysis tooling: :mod:`.contracts` (``@shape_contract``
shape/dtype contracts on the array APIs, ``RDP_CONTRACTS=0`` disables
them), :mod:`.recompile` (capture budgets), :mod:`.statecheck` and
:mod:`.explore` (the schedule explorer)."""

from robotic_discovery_platform_tpu_torch.analysis.contracts import (
    ContractError,
    mapped,
    shape_contract,
)

__all__ = ["ContractError", "mapped", "shape_contract"]
