"""PyTorch/CUDA port of `kaldi_lstm_tpu`, the projected-LSTM (LSTMP)
acoustic-model framework.

The package keeps the JAX package's layout and module names so each
counterpart is easy to find, and imports nothing from it: what it needs
of the framework-free host code (Kaldi I/O, logging) it carries as its
own copy. Hot loops are hand-written CUDA kernels under ``csrc/``,
built on first use (``ops/_build.py``); every kernel wrapper takes its
plain PyTorch version only for tensors that lie on the CPU.

Ported so far: whole-utterance acoustic-model scoring (the
``nnet-forward`` half of every decode) and the tools to make and convert
the models it scores; training; and the fused score->decode path
(``tools/nnet_decode.py``), whose word search runs on the host in the
native core ``csrc/kltdecode.cc`` (C++, built with g++ at first use by
``io/native.py``).
"""
