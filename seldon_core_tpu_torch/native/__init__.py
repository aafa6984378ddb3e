"""Wire codecs: the native SeldonMessage JSON codec (``fastcodec``, C++
built with g++ at first use), the protobuf scan of the common tensor
request (``protowire``) and HPACK (``hpackcodec``) for the gRPC lane.  The
native data plane's binding is ``runtime/nativeplane.py``."""

from seldon_core_tpu_torch.native.fastcodec import (  # noqa: F401
    format_data_fragment,
    native_available,
    parse_message_fast,
)
