"""3x3 stride-1 SAME convolution: the CUDA kernel and its plain version.

``conv3x3(x, w)`` takes ``x`` (B, H, W, Cin) NHWC and ``w`` (3, 3, Cin,
Cout) HWIO and returns ``y`` (B, H, W, Cout) in ``x``'s dtype. Both operands
are rounded to bf16 (round to nearest even), the products are accumulated in
float32, and the padding is one zero pixel on every side. For CUDA tensors
it launches the hand-written kernel ``csrc/conv3x3.cu`` (built at first use
by :mod:`._build`) with the tiling :func:`plan` chooses; for CPU tensors it
runs the plain PyTorch version, :func:`conv3x3_plain`. There is no switch
and no fallback: a kernel that fails to build or launch raises.

The kernel replaces the JAX package's Pallas kernel
``tools/pallas_conv3x3_experiment.py`` ``_kernel`` (launched by
``conv3x3_pallas``), with the same interface as that module: ``conv3x3``
and its reference. Like the JAX module, it is an op of its own; no model of
either package calls it.
"""

from __future__ import annotations

import functools
import math
from ctypes import c_int, c_void_p
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _build

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
# mscd_conv3x3(x, wk, y, out_dtype, batch, height, width, cin, cout, tile_w,
# block_n, m_blocks, a_stages, b_stages, grid, stream)
ARGTYPES = (c_void_p,) * 3 + (c_int,) * 12 + (c_void_p,)
# its own return codes besides a cudaError
_WHY = {-1: "cuTensorMapEncodeTiled is not among the CUDA entry points",
        -2: "a tensor map was refused",
        -3: "the kernel does not take the plan of these shapes (conv3x3.plan)"}
# the tensor maps need rows of whole 16-byte units: 8 bf16 channels
CHANNEL_MULTIPLE = 8

# the kernel's shape (csrc/conv3x3.cu): two consumer warpgroups, each with
# m_blocks blocks of 64 output pixels (tiles of 128 or 256 pixels), input
# channels in chunks of 64
CHUNK = 64
CONSUMERS = 2
TILE_WIDTHS = (8, 16, 32, 64)          # preference order among equal padding
BLOCK_NS = (256, 128, 64, 32, 16, 8)   # wgmma widths the kernel is built for
TWO_BLOCK_NS = (64,)                   # channel tiles built with m_blocks 2
MAX_STAGING = 64 * 1024                # output staging of both warpgroups
MAX_A_STAGES = 4                       # input boxes in flight (each read by 3 taps)
MAX_B_STAGES = 8                       # weight tiles in flight (one tap each)
SMEM_LIMIT = 232_448                   # shared memory a block may use on Hopper
SMS = 132                              # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 1                      # the rings take most of an SM's shared memory


@dataclass(frozen=True)
class Plan:
    """The kernel's tiling for one call: a pixel tile of ``tile_w`` x
    ``tile_h`` (128·``m_blocks`` pixels) by ``block_n`` output channels,
    ``m_blocks`` blocks of 64 pixels per consumer warpgroup; rings of
    ``a_stages`` input boxes and ``b_stages`` weight tiles; ``grid``
    persistent blocks over ``tiles`` tiles; ``smem_bytes`` of dynamic shared
    memory a block; outputs of ``out_bytes`` each."""
    tile_w: int
    tile_h: int
    block_n: int
    m_blocks: int
    a_stages: int
    b_stages: int
    grid: int
    tiles: int
    smem_bytes: int
    out_bytes: int

    @property
    def boxes(self) -> dict:
        """The TMA boxes (elements, innermost first): an input box (the
        tile's rows and the halo rows above and below, for one horizontal
        tap and 64 channels), a weight tile (one tap, 64 channels), and one
        store of a block of 64 output pixels."""
        box_c = min(self.block_n, 128 // self.out_bytes)
        return {"x": (CHUNK, self.tile_w, self.tile_h + 2, 1),
                "w": (CHUNK, self.block_n),
                "y": (box_c, self.tile_w, 64 // self.tile_w, 1)}


def staging_bytes(block_n: int, m_blocks: int, out_bytes: int) -> int:
    """Shared memory that holds both warpgroups' outputs for the store."""
    return CONSUMERS * m_blocks * 64 * block_n * out_bytes


def smem_bytes(tile_w: int, block_n: int, m_blocks: int, out_bytes: int,
               a_stages: int, b_stages: int) -> int:
    """Dynamic shared memory of a block (``smem_bytes`` in the source):
    1024 bytes of alignment slack, the two rings, the output staging, a
    full and an empty barrier per slot."""
    a_bytes = (128 * m_blocks + 2 * tile_w) * CHUNK * 2
    return (1024 + a_stages * a_bytes + b_stages * block_n * CHUNK * 2
            + staging_bytes(block_n, m_blocks, out_bytes) + 16 * (a_stages + b_stages))


@functools.lru_cache(maxsize=256)
def plan(b: int, h: int, w: int, cin: int, cout: int, dtype: torch.dtype,
         sms: int = SMS) -> Plan:
    """The tiling for ``conv3x3`` of a (b, h, w, cin) input to ``cout``
    channels with output ``dtype``: the widest channel tile that divides
    Cout (at most 128 for float32 outputs, whose staging is twice as
    large); two 64-pixel blocks per warpgroup at a channel tile of 64 when
    the staging fits in 64 KB and the larger tiles still fill every SM,
    which halves the weight reads per pixel; the pixel tile that pads the image least, and among those
    the narrowest, whose input boxes are smallest; as many weight slots as
    shared memory holds beside two input slots (at most 8), then input
    slots with what is left (at most 4); one block per SM."""
    if cin % CHANNEL_MULTIPLE or cout % CHANNEL_MULTIPLE or min(b, h, w, cin, cout) < 1:
        raise ValueError(f"no conv3x3 plan for B {b}, H {h}, W {w}, Cin {cin}, "
                         f"Cout {cout}: Cin and Cout must be positive multiples "
                         f"of {CHANNEL_MULTIPLE}")
    out_bytes = dtype.itemsize
    widest = 256 if out_bytes == 2 else 128
    block_n = next(n for n in BLOCK_NS if n <= widest and cout % n == 0)

    def padded(tw, tile_m):
        return math.ceil(w / tw) * math.ceil(h / (tile_m // tw))

    def tile_width(tile_m):
        return min(TILE_WIDTHS, key=lambda tw: (padded(tw, tile_m), TILE_WIDTHS.index(tw)))

    m_blocks = 2 if (block_n in TWO_BLOCK_NS
                     and staging_bytes(block_n, 2, out_bytes) <= MAX_STAGING
                     and b * padded(tile_width(256), 256) * (cout // block_n)
                     >= sms * BLOCKS_PER_SM) else 1
    tile_m = 128 * m_blocks
    tile_w = tile_width(tile_m)
    room = SMEM_LIMIT - smem_bytes(tile_w, block_n, m_blocks, out_bytes, 0, 0)
    a_slot = smem_bytes(tile_w, block_n, m_blocks, 0, 1, 0) - 1024
    b_slot = smem_bytes(tile_w, block_n, m_blocks, 0, 0, 1) - 1024
    b_stages = min(MAX_B_STAGES, (room - 2 * a_slot) // b_slot)
    a_stages = min(MAX_A_STAGES, (room - b_stages * b_slot) // a_slot)
    tiles = b * padded(tile_w, tile_m) * (cout // block_n)
    return Plan(tile_w=tile_w, tile_h=tile_m // tile_w, block_n=block_n,
                m_blocks=m_blocks, a_stages=a_stages, b_stages=b_stages,
                grid=min(tiles, sms * BLOCKS_PER_SM), tiles=tiles,
                smem_bytes=smem_bytes(tile_w, block_n, m_blocks, out_bytes,
                                      a_stages, b_stages),
                out_bytes=out_bytes)


_sms: dict = {}


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``x`` and ``w`` rounded to bf16, upcast to
    float32, ``F.conv2d(padding=1)`` in NCHW / OIHW, back to NHWC in
    ``x``'s dtype (the JAX module's ``conv3x3_reference`` on bf16
    operands). On the card it is compared with the kernel with
    ``torch.backends.cudnn.allow_tf32 = False``, so its float32 convolution
    is float32."""
    xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wb = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    y = F.conv2d(xb, wb, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or x.dtype not in _OUT_CODE:
        raise ValueError(f"x must be (B, H, W, Cin) float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]) \
            or w.dtype not in _OUT_CODE:
        raise ValueError(f"w must be (3, 3, {x.shape[3]}, Cout) float32 or "
                         f"bfloat16, got {tuple(w.shape)} {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x and w must share one device, got {x.device} and "
                         f"{w.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    # a view that starts mid-vector: tensor maps need 16-byte aligned bases
    return t.clone() if t.data_ptr() % 16 else t


def prepare(x: torch.Tensor, w: torch.Tensor):
    """The kernel's operands: ``x`` as contiguous bf16 (one cast for
    float32 inputs, as the JAX wrapper casts) and the weights as K-major
    (3, 3, Cout, Cin) bf16, both 16-byte aligned."""
    xb = x.to(torch.bfloat16).contiguous()
    wk = w.to(torch.bfloat16).permute(0, 1, 3, 2).contiguous()
    return _aligned(xb), _aligned(wk)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y = conv3x3_same(x, w)``: NHWC ``x``, HWIO ``w`` -> NHWC ``y`` in
    ``x``'s dtype. CUDA tensors launch the kernel (and add one to
    ``conv3x3.launches``); CPU tensors take the plain version. The kernel
    takes any B, H and W, and Cin and Cout that are multiples of 8."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3x3 kernel for device {x.device}")
    batch, height, width, cin = x.shape
    cout = w.shape[3]
    if cin % CHANNEL_MULTIPLE or cout % CHANNEL_MULTIPLE:
        raise ValueError(f"the conv3x3 kernel needs Cin and Cout that are "
                         f"multiples of {CHANNEL_MULTIPLE}, got Cin {cin}, "
                         f"Cout {cout}")
    y = torch.empty((batch, height, width, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if x.numel() == 0:       # Cin == 0: an empty sum
        return y.zero_()
    xb, wk = prepare(x, w)
    launch(xb, wk, y)
    conv3x3.launches += 1
    return y


def launch(xb: torch.Tensor, wk: torch.Tensor, y: torch.Tensor) -> None:
    """Launch the kernel on the current stream with :func:`plan`'s tiling,
    writing ``y`` (float32 or bf16, contiguous). ``xb`` and ``wk`` come
    from :func:`prepare`. ``conv3x3`` is the entry point."""
    batch, height, width, cin = xb.shape
    cout = y.shape[3]
    dev = xb.device
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    tiling = plan(batch, height, width, cin, cout, y.dtype, _sms[dev])
    _build.launch("conv3x3", "mscd_conv3x3", ARGTYPES, dev, xb.data_ptr(),
                  wk.data_ptr(), y.data_ptr(), _OUT_CODE[y.dtype], batch, height,
                  width, cin, cout, tiling.tile_w, tiling.block_n, tiling.m_blocks,
                  tiling.a_stages, tiling.b_stages, tiling.grid, why=_WHY)


conv3x3.launches = 0
