"""Registry of assigned architectures (10 archs, 40 arch×shape cells)."""
from __future__ import annotations

from repro_torch.config import ArchSpec, SHAPES

from repro_torch.configs import (  # noqa: E402
    starcoder2_7b,
    starcoder2_15b,
    smollm_135m,
    phi4_mini_3_8b,
    whisper_base,
    olmoe_1b_7b,
    dbrx_132b,
    chameleon_34b,
    mamba2_2_7b,
    recurrentgemma_9b,
)

_MODULES = (
    starcoder2_7b,
    starcoder2_15b,
    smollm_135m,
    phi4_mini_3_8b,
    whisper_base,
    olmoe_1b_7b,
    dbrx_132b,
    chameleon_34b,
    mamba2_2_7b,
    recurrentgemma_9b,
)

ARCHS: dict[str, ArchSpec] = {m.SPEC.arch_id: m.SPEC for m in _MODULES}


def get_arch(arch_id: str) -> ArchSpec:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {sorted(ARCHS)}") from None


def list_archs() -> list[str]:
    return sorted(ARCHS)


def all_cells() -> list[tuple[str, str, str]]:
    """All 40 (arch, shape, status) cells; status is 'run' or the skip reason."""
    cells = []
    for aid, spec in sorted(ARCHS.items()):
        for sname in SHAPES:
            status = spec.skip_shapes.get(sname, "run")
            cells.append((aid, sname, status))
    return cells
