"""Export: versioned serving artifacts (a ``torch.export`` program, the
serving variables and the spec assets), the exporters and the export
callbacks. The TF SavedModel writer of the JAX package is not ported."""

from tensor2robot_tpu_torch.export.async_export import (
    AsyncExportCallback,
    TD3ExportCallback,
)
from tensor2robot_tpu_torch.export.exporters import (
    BestExporter,
    LatestExporter,
    ModelExporter,
    committed_export_dirs,
    create_default_exporters,
    create_valid_result_larger,
    create_valid_result_smaller,
    gc_export_versions,
    load_model_from_export_dir,
    load_serving_fn_from_export_dir,
    load_state_from_export_dir,
    valid_export_dirs,
)
