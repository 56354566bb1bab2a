"""Device non-ideality models, spare-column repair, write-verify reports,
program-once crossbar artifacts and the chip lifecycle (aging, health,
compensation)."""
from repro_torch.device.models import (  # noqa: F401
    DeviceConfig,
    GEFF_FRAC_BITS,
    IDEAL_DEVICE,
    drift_time_factor,
    effective_cell_codes,
    effective_drift_nu,
    fault_masks,
    read_effective_codes,
    target_cell_codes,
    wants_repair,
)
from repro_torch.device.program import ProgramReport, write_verify  # noqa: F401
from repro_torch.device.repair import (  # noqa: F401
    RepairPlan,
    RepairReport,
    apply_repair,
    column_salience,
    plan_repair,
    repair_report,
    repaired_effective_cells,
    spare_budget,
)
from repro_torch.device.programmed import (  # noqa: F401
    ProgrammedLinear,
    ProgrammedModel,
    age_artifact,
    artifact_at_time,
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
from repro_torch.device.health import (  # noqa: F401
    HealthReport,
    LayerHealth,
    compensate_model,
    digital_twin,
    fit_compensation,
    health_check,
    layer_health,
    probe_artifact,
)
