"""The MSI_SR_model sub-framework of the port: the five classical, GAN and
transformer SR baselines (SwinIR, HAT, HSENet, TransENet, NDSRGAN) behind
one shared supervised trainer and ``msi.main``. Counterpart of
``fastdiffsr_tpu/msi/``; no kernel of ours runs here."""
