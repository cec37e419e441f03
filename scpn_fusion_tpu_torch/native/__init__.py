"""Native C++ host runtime (CPU lane + parity fixture for Pallas kernels)."""

from scpn_fusion_tpu_torch.native.runtime import (
    NativeGSSolver,
    build_library,
    get_runtime,
    is_available,
)

__all__ = ["NativeGSSolver", "build_library", "get_runtime", "is_available"]
