"""Multi-device layout of the port: the parameter and activation specs on
a (pod, data, model) mesh, and the ingest mesh's slot blocks."""
from repro_torch.distributed.sharding import (  # noqa: F401
    act_spec,
    batch_spec,
    constrain,
    mesh_axes,
    param_shardings,
    spec_for_param,
)
