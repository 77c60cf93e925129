from kaldi_lstm_tpu_torch.models.components import (
    AddShift,
    AffineTransform,
    BLstmProjectedStreams,
    Component,
    LstmProjected,
    LstmProjectedStreams,
    Rescale,
    Softmax,
    TimeShift,
    Transmit,
    component_from_token,
)
from kaldi_lstm_tpu_torch.models.nnet import Nnet
