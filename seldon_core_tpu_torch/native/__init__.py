"""Stdlib wire codecs: the protobuf scan of the common tensor request
(``protowire``) and HPACK (``hpackcodec``) for the gRPC lane."""
