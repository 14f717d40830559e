from . import kernel
from .kernel import stream_pack_matmul
from .ops import packed_branches, stream_pack
from .ref import stream_pack_matmul_ref

__all__ = ["kernel", "packed_branches", "stream_pack", "stream_pack_matmul",
           "stream_pack_matmul_ref"]
