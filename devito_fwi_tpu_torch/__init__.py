"""devito_fwi_tpu_torch — the PyTorch/CUDA port of devito_fwi_tpu.

A second package beside the JAX one, with the same layout: numpy host
layers (``models``, ``optimize``, ``utils``), torch operators (``ops``),
CUDA kernels written by hand for Hopper (``csrc``, built with ``nvcc`` at
first use by ``ops.cuda_build``), the FWI objective (``fwi``) and the
drivers. It imports torch, numpy and scipy, never JAX or the JAX package.

Entry points run on the card ("cuda") unless the caller passes
``device="cpu"``, which runs each kernel's plain torch twin.
"""

from .models.timeaxis import TimeAxis
from .models.sources import PointSource, Receiver, RickerSource
from .models.model import SeismicModel
from .models.geometry import AcquisitionGeometry
from .models.presets import demo_model
from .ops.wavesolver import AcousticWaveSolver
from .inversion import compute_residual, update_with_box

__version__ = "0.1.0"
