"""The ten architectures' configurations (counterpart of ``repro/configs``)."""
