"""spectral_tpu — an accelerator-native signal-analysis framework (JAX/XLA).

Rebuilds the capabilities of the reference PyQt desktop tool
Karmotr1ne/Spectrogram-Generator (see SURVEY.md) as a headless-first,
jit/vmap/pjit-friendly framework: scipy-exact PSD spectrograms, Gaussian-HMM
burst detection, band-power analytics, event/ROI algebra, IO loaders, and
on-device colormap rendering with direct PNG export.
"""

from spectral_tpu.config import SpecConfig, ViewSettings
from spectral_tpu.utils.cache import enable_compilation_cache

# NOTE: enable_compilation_cache() is NOT called at import time: it must ask
# for the default backend, and initializing an accelerator runtime as an
# import side effect both slows startup and defeats late platform overrides
# (e.g. the CLI's --cpu). Heavy entry points call it lazily instead.

__version__ = "0.1.0"

__all__ = ["SpecConfig", "ViewSettings", "__version__"]
