"""Device non-ideality models and program-once crossbar artifacts."""
from repro_torch.device.models import (  # noqa: F401
    DeviceConfig,
    GEFF_FRAC_BITS,
    IDEAL_DEVICE,
    effective_cell_codes,
    fault_masks,
    read_effective_codes,
    target_cell_codes,
    wants_repair,
)
from repro_torch.device.programmed import (  # noqa: F401
    ProgrammedLinear,
    ProgrammedModel,
    artifacts_equal,
    bind_artifacts,
    consumed_artifact_names,
    expected_artifact_names,
    name_scope,
    program_layer,
    program_model,
    programmed_linear,
    programmed_matmul,
    reset_consumed_artifact_names,
    scoped_name,
)
