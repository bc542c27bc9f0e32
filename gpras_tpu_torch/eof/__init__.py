"""EOF/PCA spatial reduction."""

from gpras_tpu_torch.eof.pca import pca_fit  # noqa: F401
from gpras_tpu_torch.eof.preprocessor import PreProcessor, compute_norths_rule  # noqa: F401
