"""The generic model scaffold: configs, layers, attention, MoE, Mamba,
xLSTM and the decoder stack (counterpart of ``repro/models``)."""
