"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. CUDA sources live in ``csrc/`` and are built by :mod:`._build`
on first use; nothing is compiled when a module is imported."""

# the model's kernels, by the name the serve and train stats record (as
# modules, so the package's attributes stay its submodules)
from . import flash_attention as _flash
from . import mamba2_ssd as _ssd
from . import rms_norm as _norm
from . import rwkv6_wkv as _wkv

KERNELS = {"flash_attention": _flash.flash_attention,
           "flash_attention_bwd": _flash.flash_attention_bwd,
           "mamba2_ssd": _ssd.mamba2_ssd,
           "mamba2_ssd_bwd": _ssd.mamba2_ssd_bwd,
           "rwkv6_wkv": _wkv.rwkv6_wkv,
           "rwkv6_wkv_bwd": _wkv.rwkv6_wkv_bwd,
           "rms_norm": _norm.rms_norm}
