"""``python -m sdnmpi_tpu_torch``: the controller's command line
(``launch.py``)."""

from sdnmpi_tpu_torch.launch import main

if __name__ == "__main__":
    main()
