from .multicrop import MultiCropDataset  # noqa: F401
from .ranker import ImageRanker  # noqa: F401
