"""The user's entry points beside ``train`` and ``serve`` (the JAX
package's ``scripts/``): ``convert`` (HF/torch weights <-> checkpoints),
``generate`` (a checkpoint's continuation of a prompt) and ``eval`` (a
checkpoint's held-out loss and accuracy). Each runs as ``python -m
pytorch_distributed_nn_tpu_torch.scripts.<name>`` and has ``main(argv) ->
int``."""
