"""nisqa_tpu_torch: PyTorch + CUDA port of nisqa_tpu for one NVIDIA H100.

Serves the NISQA, NISQA_DIM and NISQA_DE models (reference-format ``.tar``
checkpoints) over WAV / FLAC files: the front-end's DFT->mel step is a
hand-written sm_90a CUDA kernel (``csrc/dft_mel.cu``), the rest is plain
PyTorch. The JAX package ``nisqa_tpu`` is the reference it is tested
against; the port imports nothing of it (it keeps its own copies of the host
modules it needs: audio decode, filters, native loader, model args) and
never imports jax.
"""

__version__ = "0.1.0"


def load_predictor(checkpoint_path: str, batch_size: int = 32, tr_device=None,
                   **engine_kwargs):
    """One-call inference API: load a checkpoint and get a callable mapping
    audio paths -> predictions ((N, 5) for NISQA_DIM, (N, 1) for NISQA and
    NISQA_DE, which also takes ``paths_ref``, the reference of each file).

    ``tr_device`` None means CUDA (raises without a card); "cpu" runs the
    plain kernel twins. Extra kwargs reach
    :class:`nisqa_tpu_torch.data.pipeline.InferenceEngine` (e.g.
    ``precision="highest"``, ``cache_mb=0``, ``fuse_pass=False``). The
    callable takes ``fetch`` as ``predict_paths`` does; the engine (for
    ``warmup`` and ``stats``) is ``predict.engine``.
    """
    from .compat.checkpoint import load_model_from_tar
    from .data.pipeline import InferenceEngine, MsConfig
    from .model import resolve_device

    device = resolve_device(tr_device)
    model, args = load_model_from_tar(checkpoint_path, device)
    engine = InferenceEngine(model, MsConfig(args), device, batch_size=batch_size, **engine_kwargs)

    def predict(paths, paths_ref=None, fetch=True):
        return engine.predict_paths(list(paths), paths_ref, fetch=fetch)

    predict.engine = engine
    predict.model_name = model.name
    return predict
