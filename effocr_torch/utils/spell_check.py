"""Homoglyph beam spell-checker for English OCR output: a copy of the JAX
package's utils/spell_check.py (jax-free there, but the port imports
nothing of that package), pinned to it by tests/test_torch_io.py.

Per-word beam search over visually similar character substitutions,
accepting the highest-frequency dictionary word, else abbreviation /
initial / number, plus digit<->letter majority normalization.  The
frequency dictionary is pluggable: a "word count" lines file, or the
small built-in common-word list.
"""

from __future__ import annotations

import functools
import re
import string
import warnings
from typing import Dict, List, Optional, Sequence, Set, Tuple

_BUILTIN_FREQS = """the 23135851162 of 13151942776 and 12997637966 to 12136980858
a 9081174698 in 8469404971 for 5933321709 is 4705743816 on 3750423199
that 3400031103 by 3350048871 this 3228469771 with 3183110675 i 3086225277
you 2996181025 it 2813163874 not 2633487141 or 2590739907 be 2398724162
are 2393614870 from 2275595356 at 2272272772 as 2247431740 your 2062066547
all 2022459848 have 1564202750 new 1551258643 more 1544771673 an 1518266684
was 1483428678 we 1390661912 will 1356293641 home 1276852170 can 1242323499
us 1229112622 about 1226734006 if 1134987907 page 1082121730 my 1059793441
has 1046319984 search 1024093118 free 1014107316 but 999899654 our 998757982
one 993536631 other 978481319 do 950751722 no 937112320 information 932594387
time 908705570 they 883223816 site 844310242 he 842847219 up 829969374
may 827822032 what 812395582 which 810514085 their 782849411 news 755424983
out 741601852 use 719980257 any 710741293 there 701170205 see 681410380
only 661844114 so 661809559 his 660177731 when 650621178 contact 645824184
here 639711198 business 637134177 who 630927278 web 619571575 also 616829742
now 611387736 help 611054034 get 605984508 view 602279334 online 601317059
first 578161543 am 576436203 been 575019382 would 572644147 how 571848080
were 570699558 me 566617666 services 562206804 some 548829454 these 541003982
man 537657344 said 529517217 like 520642577 than 502609275 find 502043038
date 488967374 back 488024109 top 484213771 people 480303376 had 480232730
list 472590641 name 464532702 just 462836169 over 459222855 state 453104133
year 451092583 day 446236148 into 445315294 two 441398439 health 440416431
world 431934249 next 425021165 used 421438139 go 421086358 work 419483948
last 417601616 most 416210411 products 414377632 music 414028837 buy 410780176
data 406908328 make 405084642 them 403000411 should 402028056 product 399116521
system 396975018 post 392956436 her 391961061 city 390564835 add 387231739
policy 384401868 number 383787805 such 380725892 please 380046348 available 379644437
copyright 373906735 support 373512569 message 373081242 after 372948094 best 371852748
software 370517038 then 369928941 jan 366436194 good 365796396 video 365410017
well 362082755 where 360468339 info 352363058 rights 352051342 public 349286123
books 347710184 high 345413157 school 343057316 through 342373303 each 340892856
links 339926541 she 339171382 review 339067778 years 337841309 order 336631187
very 334923368 privacy 333272427 book 330959949 items 330505325 company 324272258
read 322331766 group 321842984 need 319376932 many 318391126 user 316699468
said 529517217 does 315688357 under 312800831 general 311721549 research 311638617
university 311373936 january 310345867 mail 310337185 full 309929179 map 309676581
reviews 307684103 program 306686983 life 306559205 know 306100813 games 305930896
way 305515604 days 305147791 management 304201237 part 302729303 could 302311431
great 300442763 united 299280163 hotel 297974073 real 297674493 item 296534935
international 295639201 center 293995467 must 292774716 store 291308910 travel 287719294
comments 287558448 made 287353021 development 286552009 report 286340427 off 284208200
member 283851297 details 280827841 line 280009597 terms 277705910 before 277546019
hotels 275510917 did 275369513 send 274103587 right 273620358 type 272336859
because 271323986 local 270742935 those 270014141 using 269448880 results 268180843
office 266789622 education 266738068 national 266376620 car 264720374 design 264448339
take 264349801 posted 263851272 internet 263777245 address 261886397 community 261144836
within 260358364 states 260079616 area 259294130 want 258861906 phone 256643812
shipping 256521328 reserved 256443340 subject 256217454 between 255436698 forum 254478181
family 254164055 long 252519588 based 252405204 code 250245121 show 247541986
even 245697701 black 244690155 check 244491090 special 244311841 prices 243435728
website 242876222 index 242826246 being 242783091 women 242520455 much 242326300
sign 242290578 file 241864251 link 240402653 open 239670331 today 239271204
technology 238674296 south 238581133 case 235563000 project 235262594 same 234822585
pages 234001114 version 232445953 section 232251956 own 232011861 found 232005894
sports 231864260 house 231310420 related 231127472 security 230014019 both 228648541
county 227567373 american 227534978 photo 227125249 game 227111505 members 226656153
power 226596368 while 226194991 care 225326739 network 225218991 down 224915894
computer 224177047 systems 223555915 three 223417394 total 222649459 place 220970235
end 220812328 following 220709925 download 220626128 him 219516023 without 219190105
per 218945655 access 217986984 think 217856550 north 217809513 resources 217268632
current 216987137 posts 216822128 big 216690546 media 216432510 law 216122487
control 215560453 water 215178488 history 215000515 pictures 214997918 size 214844153
art 214672371 personal 214271057 since 214086761 including 213614830 guide 213588077
shop 212793848 directory 212478325 board 212062763 location 211243333 change 210601244
white 209863729 text 208780080 small 208371878 rating 207858692 rate 207634179
government 206582673 children 206538107 during 206364385 return 205629763 students 204801188
shopping 204104275 account 203611349 times 202989668 sites 202755734 level 202563642
digital 202346767 profile 201854745 previous 201692678 form 201395192 events 201235454
love 201063526 old 199694226 john 199642644 main 199616754 call 199608869
hours 198242904 image 197874283 department 197293325 title 196676017 description 196301245
insurance 193271293 another 192535750 why 192000672 shall 191963867 property 191783393
class 191087771 cd 190859046 still 190433487 money 190205072 quality 189509533
every 189325890 listing 188985252 content 188880495 country 188691168 private 187885878
little 187142519 visit 187062316 save 186091095 tools 185555874 low 184815478
reply 184777992 customer 184406888 december 183237239 compare 183202885 movies 182739567
include 182579275 college 182545426 value 182061247 article 181969355 york 181556155
man 180887667 card 180845746 jobs 180599264 provide 180458372 food 180330124
source 180007976 author 179497996 different 179067537 press 178953460 learn 178798799
sale 178755072 around 178655212 print 178319022 course 177973329 job 177919786
canada 177648041 process 177623782 teen 177490519 room 176999193 stock 176907836
training 176836620 too 176513242 credit 176407214 point 176280419 join 175983660
science 175877669 men 175390871 categories 175287918 advanced 175168844 west 174924926
sales 174910106 look 174812544 english 174309858 left 174298278 team 174151472
estate 173735129 box 173586806 conditions 173398857 select 173071008 windows 172981754
photos 172860830 gay 172717775 thread 172605873 week 172370281 category 172340011
note 171452183 live 171329965 large 171226537 gallery 171133023 table 171054731
register 170712227 however 170471015 june 170205624 october 170031236 november 169782802
market 169197967 library 168843129 really 168760894 action 168670567 start 168194313
series 167541120 model 167393692 features 167389585 air 167286126 industry 166871937
plan 166569693 human 166527737 provided 166315269 yes 166291219 required 166117574
second 165981606 hot 165862330 accessories 165460443 cost 165382457 movie 164989532
forums 164965254 march 164871912 september 164810033 better 164569699 say 164283395"""

_SPLITTER_PATTERN = r"( |/|-|\"|')"

HOMOGLYPHS: Dict[str, List[str]] = {
    "0": list("O"), "O": list("0C"), "o": list("0c"),
    "1": list("li"), "l": list("i1"), "i": list("lj1"), "j": list("i"),
    "I": list("l1"), "|": list("li1"),
    "v": list("y"), "V": list("Y"), "y": list("v"),
    "q": list("d"), "d": list("q"), "p": list("b"), "b": list("p"),
    "h": list("n"), "n": list("h"), "c": list("o"), "C": list("O"),
    "f": list("t"), "t": list("f"), "2": list("a"), "@": list("a"),
    ",": list("."), "-": list("."), "z": list("s"), "9": list("g"),
    "H": ["ll"],
}

COMMON_ABBREVS: Set[str] = {
    "dr.", "est.", "i.e.", "jr.", "inc.", "ltd.",
    "mr.", "mrs.", "ms.", "oz.", "sr.", "vs.", "e.g.",
}


def depunctuate(s: str) -> str:
    return s.translate(str.maketrans("", "", ',.?!$%&():;-"'))


def create_worddict(dictionary_path: Optional[str] = None) -> Dict[str, int]:
    """word -> frequency.  With no path, uses the built-in common-word list.
    Abbreviation stems are removed like the reference (spell_check_utils.py:18-23)."""
    worddict: Dict[str, int] = {}
    if dictionary_path is not None:
        with open(dictionary_path) as f:
            text = f.read()
    else:
        # The builtin list is ~560 words (the reference ships symspell's
        # 82k-word list, utils/spell_check_utils.py:14-23, which isn't
        # redistributable here).  Small dictionaries can *hurt* CER by
        # "correcting" valid words the list lacks — measured in round 1.
        warnings.warn(
            "spell check is using the ~560-word builtin frequency list; "
            "corrections outside it can hurt CER. Build a corpus dictionary "
            "with `python -m effocr_tpu build-freq-dict` and pass "
            "--dictionary_path.",
            stacklevel=2,
        )
        text = _BUILTIN_FREQS
    tokens = text.split()
    for w, c in zip(tokens[::2], tokens[1::2]):
        worddict[w] = int(c)
    for a in COMMON_ABBREVS:
        worddict.pop(depunctuate(a), None)
    return worddict


def create_homoglyph_dict() -> Dict[str, List[str]]:
    return dict(HOMOGLYPHS)


def load_homoglyph_pairs(path: str) -> Dict[str, List[str]]:
    """Extra visual-similarity pairs, one 'a b' per line (symmetric).

    Written by `build-homoglyphs` from a trained prototype index: chars
    whose embeddings are nearest neighbors are exactly the confusions the
    recognizer makes, so the beam search should try them — the built-in
    table is the reference's hand-curated list and misses
    artifact-specific pairs (u<->n on the en demo corpus)."""
    out: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split()
            if len(parts) != 2:
                continue
            a, b = parts
            out.setdefault(a, []).append(b)
            out.setdefault(b, []).append(a)
    return out


def merge_homoglyphs(
    base: Dict[str, List[str]], extra: Dict[str, List[str]]
) -> Dict[str, List[str]]:
    """Union of visual-similarity tables, order-preserving, deduped."""
    merged = {k: list(v) for k, v in base.items()}
    for k, vs in extra.items():
        cur = merged.setdefault(k, [])
        for v in vs:
            if v not in cur and v != k:
                cur.append(v)
    return merged


def create_common_abbrev() -> Set[str]:
    return set(COMMON_ABBREVS)


@functools.lru_cache(maxsize=4)
def default_dicts(
    dictionary_path: Optional[str] = None,
    homoglyphs_path: Optional[str] = None,
) -> Tuple[Dict[str, int], Dict[str, List[str]], Set[str]]:
    """Cached (worddict, homoglyphs, abbrevs) — the spell checker is called
    once per decoded line on the inference hot path.  homoglyphs_path
    extends the built-in table with artifact-derived pairs
    (load_homoglyph_pairs)."""
    vsim = create_homoglyph_dict()
    if homoglyphs_path:
        vsim = merge_homoglyphs(vsim, load_homoglyph_pairs(homoglyphs_path))
    return (create_worddict(dictionary_path), vsim, create_common_abbrev())


def is_number(s: str) -> bool:
    return depunctuate(s).isdigit()


def is_word(s: str, worddict: Dict[str, int]) -> bool:
    return depunctuate(s.lower()) in worddict


def is_initial(s: str) -> bool:
    return len(s) == 2 and s[0].isupper() and s[0].isalpha() and s[1] == "."


def is_abbrev(s: str, abbrevset: Set[str]) -> bool:
    return s.lower() in abbrevset


def all_caps(s: str) -> bool:
    return all(c.isupper() for c in s)


def _safe_is_alpha(s: str, i: int) -> bool:
    return True if i < 0 or i >= len(s) else s[i].isalpha()


def _safe_is_digit(s: str, i: int) -> bool:
    return True if i < 0 or i >= len(s) else s[i].isdigit()


def majority_normalize(s: str, simdict: Dict[str, List[str]]) -> str:
    """Repair isolated digits inside letter-words and vice versa
    (spell_check_utils.py:98-119)."""
    num_digits = sum(1 for c in s if c.isdigit())
    num_alphas = sum(1 for c in s if c.isalpha())
    out = ""
    if num_alphas > num_digits:
        for i, c in enumerate(s):
            if (c.isdigit() and _safe_is_alpha(s, i - 1)
                    and _safe_is_alpha(s, i + 1) and c in simdict):
                out += simdict[c][0]
            else:
                out += c
    elif num_digits > num_alphas:
        for i, c in enumerate(s):
            if (c.isalpha() and _safe_is_digit(s, i - 1)
                    and _safe_is_digit(s, i + 1) and c in simdict):
                digits = [x for x in simdict[c] if x.isdigit()]
                out += digits[0] if digits else c
            else:
                out += c
    else:
        out = s
    return out


def visual_spell_checker(
    textline: str,
    worddict: Optional[Dict[str, int]] = None,
    vsim_dict: Optional[Dict[str, List[str]]] = None,
    abbrevset: Optional[Set[str]] = None,
    beam: int = 1000,
    majority_norm: bool = True,
) -> str:
    """Beam search over homoglyph substitutions per word
    (spell_check_utils.py:155-245)."""
    if worddict is None or vsim_dict is None or abbrevset is None:
        wd, sd, ab = default_dicts()
        worddict = worddict or wd
        vsim_dict = vsim_dict or sd
        abbrevset = abbrevset or ab

    splitters = _SPLITTER_PATTERN[1:-1].split("|")
    out_words: List[str] = []

    for w in re.split(_SPLITTER_PATTERN, textline):
        if len(w) > 0 and w not in splitters:
            if not is_word(w, worddict) and not is_number(w) and not all_caps(w):
                candidates = [w]
                words_in_dict: List[str] = []
                numbers: List[str] = []
                initials: List[str] = []
                abbrevs: List[str] = []
                for idx, c in enumerate(w):
                    if c in vsim_dict:
                        for alt in vsim_dict[c]:
                            new_candidates = []
                            for cw in candidates:
                                altw = cw[:idx] + alt + cw[idx + 1 :]
                                if is_word(altw, worddict):
                                    words_in_dict.append(altw)
                                elif is_abbrev(altw, abbrevset):
                                    abbrevs.append(altw)
                                elif is_number(altw):
                                    numbers.append(altw)
                                elif is_initial(altw):
                                    initials.append(altw)
                                new_candidates.append(altw)
                            candidates += new_candidates
                            candidates = candidates[-beam:]
                if words_in_dict:
                    freqs = [
                        worddict[depunctuate(rw).lower()]
                        for rw in words_in_dict
                    ]
                    out_words.append(words_in_dict[freqs.index(max(freqs))])
                elif abbrevs:
                    out_words.append(abbrevs[0])
                elif initials:
                    out_words.append(initials[0])
                elif numbers:
                    out_words.append(numbers[0])
                else:
                    out_words.append(w)
            else:
                out_words.append(w)
        else:
            out_words.append(w)

    if majority_norm:
        out_words = [
            majority_normalize(w, vsim_dict)
            if w not in splitters and not is_number(w) else w
            for w in out_words
        ]
    return "".join(out_words)
