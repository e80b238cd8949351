"""The port's own font stack: the sfnt reader (sfnt.py), HarfBuzz's
default shaping (shaping.py) and Pillow's text drawing (imagefont.py),
over native/glyph.cpp's hinted outlines and gray rasterizer."""
