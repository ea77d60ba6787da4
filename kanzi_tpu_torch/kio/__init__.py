from .compressed_stream import (Writer, Reader, compress_block_payload,  # noqa: F401
                                frame_table)
from .null_stream import NullOutputStream  # noqa: F401
