from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticRecsys, make_recsys_silos, make_lm_batches,
)
from repro_torch.data.vertical import vertical_partition  # noqa: F401
