"""Codecs (payload bytes <-> typed columns). Importing this package
registers the ``json`` and ``protobuf`` codecs."""

import arkflow_tpu_torch.plugins.codec.json_codec  # noqa: F401
import arkflow_tpu_torch.plugins.codec.protobuf_codec  # noqa: F401

from arkflow_tpu_torch.plugins.codec.helper import (  # noqa: F401
    build_codec,
    check_codec,
    decode_payloads,
    encode_batch,
)
