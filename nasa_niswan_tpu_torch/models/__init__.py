from nasa_niswan_tpu_torch.models.convlstm import (
    ConvLSTM,
    ConvLSTMConfig,
    convlstm_apply,
    convlstm_init,
    convlstm_param_count,
)
