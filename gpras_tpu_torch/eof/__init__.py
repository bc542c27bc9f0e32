"""EOF/PCA spatial reduction and forcing feature engineering."""

from gpras_tpu_torch.eof.pca import pca_fit  # noqa: F401
from gpras_tpu_torch.eof.preprocessor import (  # noqa: F401
    HmsPreProcessor,
    PreProcessor,
    compute_norths_rule,
)
