"""Model layer of the port: the fitted word2vec and fastText models and
their loader."""

import json
import os

from glint_word2vec_torch.device import DeviceLike


def load_model(path: str, mesh=None, device: DeviceLike = None):
    """Load a saved model directory (written by either package),
    dispatching on its ``params.json``: a fastText model (its params carry
    ``bucket``) loads as a ``FastTextModel``, any other as a
    ``Word2VecModel``. ``mesh`` (``parallel/mesh.make_mesh``) re-homes the
    tables onto that mesh; without one they load onto ``device``."""
    params_path = os.path.join(path, "params.json")
    try:
        with open(params_path) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(f"no model at {path!r} (missing params.json)")
    except OSError as e:
        raise ValueError(f"cannot read model metadata at {params_path}: {e}")
    except json.JSONDecodeError as e:
        raise ValueError(f"corrupt model metadata at {params_path}: {e}")
    if "bucket" in meta:
        from glint_word2vec_torch.models.fasttext import FastTextModel

        return FastTextModel.load(path, device=device, mesh=mesh)
    from glint_word2vec_torch.models.word2vec import Word2VecModel

    return Word2VecModel.load(path, device=device, mesh=mesh)
