"""MovieLens-100k fetcher: the port of ``skrx.io.movielens``.

``download`` fetches ``ml-100k.zip`` from grouplens into ``data_dir``
unless the file is already there; ``extract`` copies its ``u.data`` to
``ml-100k.rating`` (tab-separated user, item, rating, time), ready for
:class:`skrx_torch.io.Preprocessor`. Without a network, place the zip in
``data_dir`` first, or generate data with :mod:`skrx_torch.io.synthetic`.
"""
import os
import shutil
import urllib.request
import zipfile

__all__ = ["MovieLens100k"]

_URL = "https://files.grouplens.org/datasets/movielens/ml-100k.zip"


class MovieLens100k:
    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        self.zip_path = os.path.join(data_dir, "ml-100k.zip")
        self.rating_path = os.path.join(data_dir, "ml-100k.rating")

    def download(self) -> str:
        os.makedirs(self.data_dir, exist_ok=True)
        if not os.path.exists(self.zip_path):
            urllib.request.urlretrieve(_URL, self.zip_path)
        return self.zip_path

    def extract(self) -> str:
        with zipfile.ZipFile(self.zip_path) as zf:
            with zf.open("ml-100k/u.data") as src, \
                    open(self.rating_path, "wb") as dst:
                shutil.copyfileobj(src, dst)
        return self.rating_path

    def download_and_extract(self) -> str:
        self.download()
        return self.extract()
