"""Self-supervised audio-reactive patches (port of
`maua_tpu/audiovisual/selfsupervised`)."""

from .mir import retrieve_music_information  # noqa: F401
from .patch import Patch  # noqa: F401
