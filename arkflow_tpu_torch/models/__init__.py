"""Model families of the port: ``bert_classifier`` and ``decoder_lm``."""

from arkflow_tpu_torch.models.registry import get_model, register_model  # noqa: F401

import arkflow_tpu_torch.models.bert  # noqa: F401
import arkflow_tpu_torch.models.decoder  # noqa: F401
