"""`python -m maua_tpu_torch.nca`: the texture NCA's command (also `python -m maua_tpu_torch nca run`)."""

from .nca import main

if __name__ == "__main__":
    main()
