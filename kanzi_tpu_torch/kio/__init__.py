from .compressed_stream import Writer, Reader, compress_block_payload  # noqa: F401
from .null_stream import NullOutputStream  # noqa: F401
