"""COCO error analysis, precision curves only (counterpart of
``tools/coco_error_analysis.py``): ``coco_error_analysis_f1`` without the
F1 curves and ``maxF1score.txt``.

    python -m bonai_tpu_torch.tools.coco_error_analysis RESULT.pkl OUT_DIR \\
        --ann GT.json [--types bbox segm] [--no-plots]
"""

from __future__ import annotations

from .coco_error_analysis_f1 import main

if __name__ == "__main__":
    main(with_f1=False)
