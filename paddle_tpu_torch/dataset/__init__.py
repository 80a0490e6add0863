"""paddle_tpu_torch.dataset — the image datasets.

Counterpart of ``paddle_tpu/dataset``'s image readers: ``common``,
``image``, ``mnist``, ``cifar`` and ``flowers``. Real files are read where
they are cached under ``common.DATA_HOME``; otherwise each module
generates the reference's deterministic synthetic corpus, bit for bit,
with the real dataset's sample format. Nothing is downloaded.

The text datasets (``imdb``, ``imikolov``, ``movielens``, ``uci_housing``,
``wmt14``, ``wmt16``, ``conll05``, ``sentiment``, ``voc2012``,
``mq2007``) are not ported yet (ROADMAP.md Queue A item 21).
"""
from . import common
from . import mnist
from . import cifar
from . import image
from . import flowers

__all__ = ["common", "mnist", "cifar", "flowers", "image"]
