"""The RNN toolkit: cells, the bucketed sentence iterator and the RNN
checkpoint helpers (the counterpart of ``mxnet_tpu/rnn/``)."""
from .rnn_cell import (BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell, ZoneoutCell, ResidualCell, ModifierCell,
                       RNNParams)
from .io import BucketSentenceIter, encode_sentences
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint,
                  do_rnn_checkpoint)
