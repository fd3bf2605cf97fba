from repro_torch.data.synthetic import SyntheticLM, make_batch  # noqa: F401
from repro_torch.data.microbatch import split_microbatches  # noqa: F401
