"""nisqa_tpu_torch: PyTorch + CUDA port of nisqa_tpu for one NVIDIA H100.

Serves the NISQA and NISQA_DIM models (reference-format ``.tar``
checkpoints) over WAV / FLAC files: the front-end's DFT->mel step is a
hand-written sm_90a CUDA kernel (``csrc/dft_mel.cu``), the rest is plain
PyTorch. The JAX package ``nisqa_tpu`` is the reference it is tested
against; from it the port imports only framework-free host modules (audio
decode, filters, native loader, model args). It never imports jax.
"""

__version__ = "0.1.0"

import os as _os


def _import_host_package():
    """Import ``nisqa_tpu`` for its host modules without importing jax.

    ``nisqa_tpu/__init__.py`` configures JAX's persistent compilation cache
    (which imports jax, where installed) unless ``NISQA_TPU_NO_CACHE`` is
    set; the port sets it for that one import and restores it after.
    """
    prev = _os.environ.get("NISQA_TPU_NO_CACHE")
    _os.environ["NISQA_TPU_NO_CACHE"] = "1"
    try:
        import nisqa_tpu  # noqa: F401
    finally:
        if prev is None:
            del _os.environ["NISQA_TPU_NO_CACHE"]
        else:
            _os.environ["NISQA_TPU_NO_CACHE"] = prev


_import_host_package()


def load_predictor(checkpoint_path: str, batch_size: int = 32, tr_device=None,
                   **engine_kwargs):
    """One-call inference API: load a checkpoint and get a callable mapping
    audio paths -> predictions ((N, 5) for NISQA_DIM, (N, 1) for NISQA).

    ``tr_device`` None means CUDA (raises without a card); "cpu" runs the
    plain kernel twins. Extra kwargs reach
    :class:`nisqa_tpu_torch.data.pipeline.InferenceEngine` (e.g.
    ``precision="highest"``).
    """
    from .compat.checkpoint import load_model_from_tar
    from .data.pipeline import InferenceEngine, MsConfig
    from .model import resolve_device

    device = resolve_device(tr_device)
    model, args = load_model_from_tar(checkpoint_path, device)
    engine = InferenceEngine(model, MsConfig(args), device, batch_size=batch_size, **engine_kwargs)

    def predict(paths):
        return engine.predict_paths(list(paths))

    predict.engine = engine
    predict.model_name = model.name
    return predict
