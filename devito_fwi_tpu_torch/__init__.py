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
from .models.sources import (PointSource, Receiver, Shot, WaveletSource,
                             RickerSource, GaborSource, DGaussSource)
from .models.model import (SeismicModel, Model, ModelElastic,
                           ModelViscoelastic, ModelViscoacoustic)
from .models.geometry import (AcquisitionGeometry, setup_geometry,
                              setup_rec_coords, seismic_args)
from .models.presets import demo_model, load_velocity
from .ops.wavesolver import AcousticWaveSolver
from .ops.sa_wavesolver import SaIsoAcousticWaveSolver, acoustic_sa_setup
from .ops.elastic_wavesolver import ElasticWaveSolver, ViscoelasticWaveSolver
from .ops.viscoacoustic_wavesolver import ViscoacousticWaveSolver
from .ops.tti_wavesolver import AnisotropicWaveSolver
from .ops.self_adjoint import setup_w_over_q
from .utils.plotting import (plot_perturbation, plot_velocity,
                             plot_shotrecord, plot_image)
from .inversion import compute_residual, update_with_box

__version__ = "0.1.0"
